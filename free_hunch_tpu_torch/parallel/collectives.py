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

Shards may be uneven (``parallel/mesh.py::plan_shards``, ``split_sizes``):
the gathers, ``scatter`` and ``halo_rows`` take the ranks' sizes along the
sharded dimension (``sizes``; default equal shards), a slot is as large as
the largest shard, and a rank with no rows adds zeros: it sends nothing a
neighbour reads and receives nothing. ``all_max`` is the max-merge (the
dynamic int8 torso's per-sample abs-max), a gather of slots and a max.

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

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from free_hunch_tpu_torch.parallel.mesh import ModelGroup, split_sizes

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


def _sizes(x: torch.Tensor, dim: int, mg: ModelGroup,
           sizes: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """The ranks' sizes on ``dim`` (equal to this rank's by default),
    checked against this rank's."""
    sizes = (x.shape[dim],) * mg.model_size if sizes is None else tuple(int(s) for s in sizes)
    if len(sizes) != mg.model_size or sizes[mg.model_index] != x.shape[dim]:
        raise ValueError(f"rank {mg.model_index}: {x.shape[dim]} on dim {dim}, but the "
                         f"shard sizes are {sizes}")
    return sizes


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` with zeros appended on ``dim`` up to ``size`` (differentiable)."""
    if x.shape[dim] == size:
        return x
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _slot(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """(model_size, *x.shape) zeros with ``x`` in this rank's slot."""
    parts = [torch.zeros_like(x)] * mg.model_size
    parts[mg.model_index] = x
    return torch.stack(parts)


def _cat_slots(buf: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """The slots' first ``sizes[r]`` entries on ``dim``, in rank order."""
    return torch.cat([b.narrow(dim, 0, n) for b, n in zip(buf.unbind(0), sizes)], dim=dim)


def _gather(x: torch.Tensor, dim: int, mg: ModelGroup, sizes) -> torch.Tensor:
    """The ranks' ``x`` on ``dim`` in rank order: one sum of slots as large
    as the largest shard."""
    return _cat_slots(_sum(_slot(_pad_to(x, dim, max(sizes)), mg), mg), dim, sizes)


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
    def forward(ctx, x, mg, dim, sizes):
        ctx.dim, ctx.start, ctx.n = dim, sum(sizes[:mg.model_index]), x.shape[dim]
        return _gather(x, dim, mg, sizes)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's slice of a replicated ``x`` on ``dim``; the backward
    gathers the ranks' cotangent slices (each rank's part of the
    replicated input's cotangent)."""

    @staticmethod
    def forward(ctx, x, mg, dim, sizes):
        ctx.mg, ctx.dim, ctx.sizes = mg, dim, sizes
        return x.narrow(dim, sum(sizes[:mg.model_index]), sizes[mg.model_index]).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.dim, ctx.mg, ctx.sizes), None, None, None


def all_reduce(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Sum of ``x`` over the model group, differentiable (a partial
    output: the backward sums the cotangents)."""
    return _AllReduce.apply(x, mg)


def all_max(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Elementwise max of ``x`` over the model group: one sum of slots, then
    a max over them, so every rank gets the same bits. Differentiable (a
    partial output: a tie shares the cotangent as ``amax`` does)."""
    return _AllReduce.apply(_slot(x, mg), mg).amax(dim=0)


def gather_partial(x: torch.Tensor, dim: int, mg: ModelGroup,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order, each rank to
    use for its own part (attention's keys and values); ``sizes`` are the
    ranks' sizes on ``dim``. The backward sums the ranks' cotangents and
    takes this rank's slot."""
    sizes = _sizes(x, dim, mg, sizes)
    return _cat_slots(_AllReduce.apply(_slot(_pad_to(x, dim, max(sizes)), mg), mg), dim,
                      sizes)


def gather_replicated(x: torch.Tensor, dim: int, mg: ModelGroup,
                      sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order, replicated
    (the UNet's output); ``sizes`` are the ranks' sizes on ``dim``. The
    backward takes this rank's slot."""
    return _GatherReplicated.apply(x, mg, dim, _sizes(x, dim, mg, sizes))


def scatter(x: torch.Tensor, dim: int, mg: ModelGroup,
            sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's contiguous block of a replicated ``x`` on ``dim``: of
    ``sizes[rank]`` entries, by default ``split_sizes``'s even blocks. The
    backward gathers."""
    sizes = split_sizes(x.shape[dim], mg.model_size) if sizes is None else tuple(sizes)
    if sum(sizes) != x.shape[dim] or len(sizes) != mg.model_size:
        raise ValueError(f"scatter: shard sizes {sizes} of {x.shape[dim]} over "
                         f"{mg.model_size} ranks")
    return _Scatter.apply(x, mg, dim, sizes)


def _neighbours(mg: ModelGroup, sizes) -> Tuple[Optional[int], Optional[int]]:
    """The nearest ranks above and below this one that hold rows (None at
    the image's edge)."""
    i = mg.model_index
    above = next((j for j in range(i - 1, -1, -1) if sizes[j]), None)
    below = next((j for j in range(i + 1, mg.model_size) if sizes[j]), None)
    return above, below


def _ends(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``'s first and last row on ``dim`` (zeros for an empty ``x``)."""
    n = x.shape[dim]
    if n == 0:
        shape = list(x.shape)
        shape[dim] = 2
        return x.new_zeros(shape)
    return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)], dim=dim)


class _Halo(torch.autograd.Function):
    """``x`` with the row above from the nearest rank above that has rows
    and the row below from the nearest one below, zeros at the image's
    edges: one sum of every rank's first and last rows. The backward is
    the same exchange run backwards: the halo rows' cotangents go to the
    ranks that sent them, which add them to their edge rows."""

    @staticmethod
    def forward(ctx, x, mg, dim, sizes):
        ctx.mg, ctx.dim, ctx.sizes = mg, dim, sizes
        both = _sum(_slot(_ends(x, dim), mg), mg)          # (M, ..., 2 rows, ...)
        if x.shape[dim] == 0:
            return x.clone()
        above, below = _neighbours(mg, sizes)
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        up = both[above].narrow(dim, 1, 1) if above is not None else zero
        down = both[below].narrow(dim, 0, 1) if below is not None else zero
        return torch.cat([up, x, down], dim=dim)

    @staticmethod
    def backward(ctx, g):
        mg, dim, sizes = ctx.mg, ctx.dim, ctx.sizes
        n = g.shape[dim]
        sent = _ends(g, dim) if n == 0 else torch.cat([g.narrow(dim, 0, 1),
                                                      g.narrow(dim, n - 1, 1)], dim=dim)
        both = _sum(_slot(sent, mg), mg)
        if n == 0:
            return g.clone(), None, None, None
        above, below = _neighbours(mg, sizes)
        dx = g.narrow(dim, 1, n - 2).clone()
        # the rank above's bottom halo row is this rank's first row, the
        # rank below's top halo row its last
        if above is not None:
            dx.narrow(dim, 0, 1).add_(both[above].narrow(dim, 1, 1))
        if below is not None:
            dx.narrow(dim, n - 3, 1).add_(both[below].narrow(dim, 0, 1))
        return dx, None, None, None


def halo_rows(x: torch.Tensor, mg: ModelGroup, dim: int = 2,
              sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x`` (this rank's rows of an image on ``dim``) with one row above
    from the nearest rank above that has rows and one below from the
    nearest one below, zeros at the image's edges, as a 3x3 convolution's
    padding has: one all_reduce of every rank's first and last row.
    ``sizes``: the ranks' rows (default: every rank has some); a rank with
    none gets none. Any dtype (the int8 torso exchanges its codes).
    Differentiable (a halo row's cotangent goes back to the rank that sent
    it)."""
    return _Halo.apply(x, mg, dim, _sizes(x, dim, mg, sizes))


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
