"""The Free Hunch covariance state sharded on d over a model group.

Counterpart of ``free_hunch_tpu/parallel/sharded_cov.py`` (:29-62). Each
rank of the group holds one contiguous d / model_size block of ``diag``
(B, d) and of ``Ut`` (B, K, d), as ``P(model)`` on their last axis places
them; ``M`` and ``k`` are replicated. A matvec is

    Sigma0 @ v = diag * v + (M @ allreduce(Ut v)) @ Ut

on the rank's block of v: one K-length reduction. The algebra is
``ops/lowrank.py``'s and ``guidance/covariance.py``'s, with ``reduce`` the
group's all_reduce (``model_reduce``); there is no second copy of it.
"""
from __future__ import annotations

import torch

from free_hunch_tpu_torch.ops.lowrank import LowRank, Reduce
from free_hunch_tpu_torch.parallel import collectives as coll
from free_hunch_tpu_torch.parallel.mesh import ITEM_15B, ModelGroup


def d_block(d: int, mg: ModelGroup) -> slice:
    """This rank's contiguous block of d; raises where the model size does
    not divide d."""
    if d % mg.model_size:
        raise ValueError(f"d-sharded state: a model axis of {mg.model_size} does not divide "
                         f"d = {d} ({ITEM_15B}: ragged shards)")
    n = d // mg.model_size
    return slice(mg.model_index * n, (mg.model_index + 1) * n)


def shard_state(cov: LowRank, mg: ModelGroup) -> LowRank:
    """This rank's d-block of a whole (B, ...) state: ``diag`` and ``Ut``
    cut on their last axis, ``M`` and ``k`` kept whole
    (``FreeHunch.init_state`` shards its fresh state so)."""
    blk = d_block(cov.diag.shape[-1], mg)
    return LowRank(diag=cov.diag[:, blk].contiguous(), Ut=cov.Ut[..., blk].contiguous(),
                   M=cov.M, k=cov.k)


def model_reduce(mg: ModelGroup) -> Reduce:
    """The ``reduce`` of a d-sharded state: the group's all_reduce. With it
    ``lowrank.matvec`` on a rank's block is the sharded matvec of JAX's
    ``sharded_matvec``."""
    return lambda t: coll.all_reduce(t, mg)


def gather_d(v: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The whole (B, d) vector from every rank's (B, d / model_size) block,
    replicated."""
    return coll.gather_replicated(v, v.dim() - 1, mg)
