"""The model group's collectives, with their gradients.

Where the JAX package's model axis is a sharding annotation and GSPMD
inserts the halo exchanges, the GroupNorm reductions and the psums
(``free_hunch_tpu/models/unet.py:399-406``,
``free_hunch_tpu/parallel/sharded_cov.py:46-62``), the port writes them out
over the ``torch.distributed`` subgroup of a ``parallel.mesh.ModelGroup``.

Every collective here is one ``all_reduce`` (sum): a gather is the sum of a
zero-filled buffer in which each rank wrote its own slot, and adding zeros
is exact, so the gather is bitwise and every rank of the group gets the
same bits. That runs on gloo on the CPU, on gloo with CUDA tensors (which
has no ``all_gather`` or ``send``/``recv`` for them) and on nccl.
nccl's native gather and point-to-point calls are ROADMAP item 15b.

Two kinds of gradient, by what the output is:

* a *partial* output, which each rank goes on to use for its own part of
  the result (a GroupNorm's sums, the keys and values attention gathers,
  a halo row): the backward sums the ranks' cotangents (``all_reduce``);
* a *replicated* output, which every rank holds whole and goes on to use
  alike (the UNet's output, gathered for the guidance algebra): every rank
  holds the whole cotangent too, so the backward takes its own slot and
  sends nothing. ``scatter`` is its dual: the slice of a replicated input,
  whose backward gathers the ranks' parts of the cotangent.

``decide`` takes a host decision on a value that should be bitwise equal
on the ranks of a model group (CG's stopping tests on replicated
vectors): it checks that the ranks agree, so that a divergence raises on
every rank at once instead of leaving the ranks in different branches,
waiting in different collectives.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist

from free_hunch_tpu_torch.parallel.mesh import ITEM_15B, ModelGroup

#: collectives issued and bytes this rank contributed to them, since the
#: last ``reset_counts`` (every call counts, forward and backward)
counts = {"calls": 0, "bytes": 0}


def reset_counts() -> None:
    counts["calls"] = 0
    counts["bytes"] = 0


def _sum(t: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The in-place sum of ``t`` over the group's ranks (a new tensor)."""
    t = t.contiguous().clone()
    counts["calls"] += 1
    counts["bytes"] += t.numel() * t.element_size()
    tdist.all_reduce(t, group=mg.group)
    return t


def _slot(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """(model_size, *x.shape) zeros with ``x`` in this rank's slot."""
    parts = [torch.zeros_like(x)] * mg.model_size
    parts[mg.model_index] = x
    return torch.stack(parts)


class _AllReduce(torch.autograd.Function):
    """Sum over the group; its backward sums the cotangents (a partial
    output)."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _sum(x, mg)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mg), None


class _GatherReplicated(torch.autograd.Function):
    """The ranks' ``x`` concatenated on ``dim`` in rank order; the output is
    replicated, so the backward takes this rank's slot of the cotangent."""

    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim, ctx.n = mg, dim, x.shape[dim]
        return _cat_slots(_sum(_slot(x, mg), mg), dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mg.model_index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    """This rank's slice of a replicated ``x`` on ``dim``; the backward
    gathers the ranks' cotangent slices (each rank's part of the
    replicated input's cotangent)."""

    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        n = x.shape[dim] // mg.model_size
        return x.narrow(dim, mg.model_index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _cat_slots(_sum(_slot(g.contiguous(), ctx.mg), ctx.mg), ctx.dim), None, None


def _cat_slots(buf: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(list(buf.unbind(0)), dim=dim)


def all_reduce(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Sum of ``x`` over the model group, differentiable (a partial
    output: the backward sums the cotangents)."""
    return _AllReduce.apply(x, mg)


def gather_partial(x: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order, each rank to
    use for its own part (attention's keys and values): the backward sums
    the ranks' cotangents and takes this rank's slot."""
    return _cat_slots(_AllReduce.apply(_slot(x, mg), mg), dim)


def gather_replicated(x: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order, replicated
    (the UNet's output): the backward takes this rank's slot."""
    return _GatherReplicated.apply(x, mg, dim)


def scatter(x: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """This rank's contiguous 1 / model_size of a replicated ``x`` on
    ``dim`` (which the model size must divide); the backward gathers."""
    if x.shape[dim] % mg.model_size:
        raise ValueError(f"scatter: a model axis of {mg.model_size} does not divide "
                         f"{x.shape[dim]} ({ITEM_15B}: ragged shards)")
    return _Scatter.apply(x, mg, dim)


def halo_rows(x: torch.Tensor, mg: ModelGroup, dim: int = 2) -> torch.Tensor:
    """``x`` (this rank's rows of an image on ``dim``) with one row above
    from the previous rank and one below from the next, zeros at the
    image's edges, as a 3x3 convolution's padding has: one all_reduce of
    every rank's first and last row. Differentiable (a halo row's
    cotangent goes back to the rank that sent it)."""
    n = x.shape[dim]
    ends = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)], dim=dim)
    both = _AllReduce.apply(_slot(ends, mg), mg)       # (M, ..., 2 rows, ...)
    i, m = mg.model_index, mg.model_size
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    above = both[i - 1].narrow(dim, 1, 1) if i > 0 else zero
    below = both[i + 1].narrow(dim, 0, 1) if i + 1 < m else zero
    return torch.cat([above, x, below], dim=dim)


def decide(flag: torch.Tensor, mg: Optional[ModelGroup] = None) -> bool:
    """``bool(flag)`` for a host decision (a scalar boolean tensor). Under a
    model group ``mg`` of more than one rank the ranks' flags are summed:
    equal flags give the decision, and unequal ones raise on every rank
    (the replicated values the flag came from were not bitwise equal)."""
    if mg is None or not mg.sharded:
        return bool(flag)
    mine = bool(flag)
    t = torch.tensor([int(mine)], dtype=torch.int64)
    if tdist.get_backend(mg.group) == "nccl":
        t = t.cuda()
    tdist.all_reduce(t, group=mg.group)
    votes = int(t.item())
    if votes not in (0, mg.model_size):
        raise RuntimeError(f"model group {mg.ranks}: {votes} of {mg.model_size} ranks took a "
                           f"host decision the others did not; the replicated values it was "
                           f"taken on differ between the ranks")
    return mine
