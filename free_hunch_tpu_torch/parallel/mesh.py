"""The mesh string of the JAX package, the model groups, and the
cross-rank mean.

Counterpart of ``free_hunch_tpu/parallel/mesh.py`` and of the JAX driver's
mesh (``free_hunch_tpu/eval.py:104-117``). There a mesh spans the devices
of one process ('data' shards a batch over them, 'model' the UNet torso's
height and the covariance's d dimension, with GSPMD inserting the
collectives); here one process drives one card, so both axes are made of
ranks. ``mesh_shape=data:N,model:M`` splits a world of N x M ranks into N
model groups of M consecutive ranks: the ranks of a group hold the same
images and weights and shard the torso's height
(``UNetModel(model_group=)``, JAX's ``spatial_partition``) and the Free
Hunch state's d (``FreeHunch(model_group=)``, JAX's ``cov_partition``)
over the group, with the collectives of
``parallel/collectives.py``; the images are strided over the N groups
(``data/dataset.py::shard_indices`` with the data index). ``model:1`` (or
no model axis) is the data-parallel world of ``torchrun
--nproc_per_node=N`` with ``mesh_shape=data:1``, as before.
``make_mesh``, ``batch_sharding``, ``replicated`` and ``shard_batch``
place arrays on the devices of one process and have no counterpart in a
process-per-card design.

Where the JAX package's GSPMD pads a shard that the model size does not
divide, the port cuts uneven shards by a plan (``plan_shards``,
``split_sizes``), and the collectives take the plan's per-rank sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from free_hunch_tpu_torch.parallel.dist import get_rank, get_world_size


def split_sizes(n: int, m: int) -> Tuple[int, ...]:
    """``n`` items over ``m`` ranks in contiguous blocks, as even as they
    go: the first ``n % m`` ranks take one more; ranks past ``n`` take
    none. The d blocks of the covariance state, and the deepest level's
    rows of a height shard."""
    q, r = divmod(int(n), int(m))
    return tuple(q + (i < r) for i in range(m))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The rows of every level of a UNet torso that each rank of a model
    group holds: ``rows[level][rank]``, level 0 the input's resolution,
    each next level half the height (``plan_shards`` says the rule)."""
    rows: Tuple[Tuple[int, ...], ...]


def plan_shards(height: int, levels: int, m: int) -> ShardPlan:
    """The height shard of a torso of ``levels`` levels (``levels - 1``
    stride-2 steps) over ``m`` ranks. The rule: the deepest level's
    ``height / 2^(levels-1)`` rows are split by ``split_sizes``, and a rank
    holds at level l its deepest rows times 2^(levels-1-l). So every
    boundary between two ranks at a level before a stride-2 step lies on an
    even row, and a 3x3 stride-2 conv or a 2x2 average pool on a rank's rows
    sees the windows of the unsharded tensor; each stride-2 step halves a
    rank's rows, and each upsampling doubles them back. Ranks past the
    deepest level's rows (5 or 8 ranks over 4) hold none at any level. Any
    split with unsharded windows gives the unsharded result, as GSPMD's
    padded shards do; this one needs no exchange but the halos. Raises
    where 2^(levels-1) does not divide the height, which the unsharded
    model does not take either."""
    unit = 2 ** (levels - 1)
    if height % unit:
        raise ValueError(f"height shard: {levels} levels halve the height {levels - 1} "
                         f"times, which {height} rows do not allow")
    deep = split_sizes(height // unit, m)
    return ShardPlan(tuple(tuple(u * 2 ** (levels - 1 - lv) for u in deep)
                           for lv in range(levels)))


def parse_mesh_shape(mesh_shape: str, n_devices: Optional[int] = None) -> Dict[str, int]:
    """'data:-1' or 'data:4,model:2' -> {'data': N, 'model': 2}, -1 filled
    from ``n_devices`` (default 1: the card this process drives). Equal to
    the JAX package's function for the same ``n_devices``."""
    n = 1 if n_devices is None else n_devices
    axes: Dict[str, int] = {}
    for part in mesh_shape.split(","):
        name, _, size = part.strip().partition(":")
        axes[name] = int(size) if size else -1
    fixed = int(np.prod([v for v in axes.values() if v > 0])) if axes else 1
    for k, v in axes.items():
        if v == -1:
            axes[k] = max(n // max(fixed, 1), 1)
    return axes


def check_mesh_shape(mesh_shape: Optional[str], world: Optional[int] = None) -> Dict[str, int]:
    """The axes of ``mesh_shape`` over a world of ``world`` ranks (default:
    this process group's): ``model`` ranks to a group, ``data`` = world //
    model groups. The data entry may be -1 or 1 (filled from the world, 1
    being the one card of each process) or that count. Raises where the
    model size does not divide the world, and for a data entry that asks
    one process for several cards or the world for more ranks."""
    world = get_world_size() if world is None else int(world)
    raw = parse_mesh_shape(mesh_shape or "data:-1", 1)
    model = raw.get("model", 1)
    if model < 1:
        raise ValueError(f"mesh_shape={mesh_shape!r}: a model axis of {model}")
    if world % model:
        raise ValueError(f"mesh_shape={mesh_shape!r}: a model axis of {model} does not "
                         f"divide the world of {world} ranks (ROADMAP item 15: a world of "
                         f"data x model ranks)")
    data = world // model
    asked = raw.get("data", 1)
    if asked not in (-1, 1, data):
        if world == 1:
            raise ValueError(f"mesh_shape={mesh_shape!r}: a data axis of {asked} asks "
                             f"one process for {asked} cards, but a process drives "
                             f"one; start {asked} ranks (torchrun --nproc_per_node="
                             f"{asked}) with mesh_shape=data:1")
        raise ValueError(f"mesh_shape={mesh_shape!r}: a data axis of {asked} with a model "
                         f"axis of {model} needs a world of {asked * model} ranks, not "
                         f"{world}")
    return {"data": data, "model": model}


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's place in a (data, model) world: its data index among
    ``data_size`` groups, its model index among the group's ``model_size``
    ranks (``ranks``, consecutive), and the group's ``torch.distributed``
    subgroup (``None`` for a group of one)."""
    data_index: int
    data_size: int
    model_index: int
    model_size: int
    ranks: Tuple[int, ...]
    group: Any = None

    @property
    def sharded(self) -> bool:
        return self.model_size > 1


def make_model_groups(mesh_shape: Optional[str], world: Optional[int] = None,
                      rank: Optional[int] = None) -> ModelGroup:
    """This rank's ``ModelGroup`` under ``mesh_shape`` (see
    ``check_mesh_shape``), which the caller passes to what shards over it
    (``UNetModel(model_group=...)``, ``FreeHunch(model_group=...)``). Every
    rank of the world must call it, in the same order: ``new_group`` is
    collective. A world of one, or ``model:1``, makes no subgroup."""
    world = get_world_size() if world is None else int(world)
    rank = get_rank() if rank is None else int(rank)
    axes = check_mesh_shape(mesh_shape, world)
    m = axes["model"]
    group = None
    if m > 1:
        # every rank creates every subgroup, in order (new_group's contract)
        for d in range(axes["data"]):
            g = tdist.new_group(list(range(d * m, (d + 1) * m)))
            if d == rank // m:
                group = g
    d = rank // m
    return ModelGroup(data_index=d, data_size=axes["data"], model_index=rank % m,
                      model_size=m, ranks=tuple(range(d * m, (d + 1) * m)), group=group)


def all_reduce_mean(value) -> float:
    """The mean of every element of ``value`` over every rank: the mean of
    the global array the ranks hold parts of (each rank's elements weigh
    equally, whatever the size of its part)."""
    arr = np.asarray(value, np.float64)
    t = torch.tensor([arr.sum(), arr.size], dtype=torch.float64)
    if get_world_size() > 1:
        if tdist.get_backend() == "nccl":
            t = t.cuda()
        tdist.all_reduce(t)
    return float(t[0] / t[1])
