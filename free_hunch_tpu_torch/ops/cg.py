"""Batched preconditioned conjugate gradients with per-row freezing.

Counterpart of ``free_hunch_tpu/ops/cg.py``: ``cg_batch`` (:37-213), with all
of its behaviour: per-row active masks, ``min_iter``, the scale-invariant
p^T A p breakdown test, best-iterate tracking (or the last iterate with
``track_best=False``), and the stall counter with its floor check; ``cg``
(:216-225), one system of any shape; ``cg_solve`` (:228-235), the
differentiable symmetric solve, whose backward is a second CG solve (the
JAX package's ``lax.custom_linear_solve(symmetric=True)``).

``lax.while_loop`` becomes a Python loop. Its ``any(active)`` test and the
floor check's ``any(stall_hit & active)`` each read one device boolean on
the host, so an iteration costs up to two host syncs; ``CGInfo.host_syncs``
counts them. Each goes through ``decide`` (default ``bool``): under a model
group, ``parallel/collectives.py::decide``, which checks that the group's
ranks, which run the CG on replicated vectors, take the same branch.
Capturing the body in a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGInfo(NamedTuple):
    niter: int                   # iterations actually run
    residual_norm: torch.Tensor  # (batch,) ||Ax - b|| of the RETURNED iterate
    optimal: torch.Tensor        # (batch,) bool: returned iterate met rtol/atol
    host_syncs: int              # device->host reads the loop made


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def cg_batch(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             precond: Optional[Callable] = None, rtol=1e-3, atol=0.0,
             maxiter: int = 1000, stall_iters: int = 25, min_iter: int = 0,
             track_best: bool = True, stall_engage: float = 0.5,
             stall_floor_check: bool = True, decide: Callable = bool):
    """Solve A x = b per batch row; b is (batch, n) and matvec maps
    (batch, n) -> (batch, n) applying a symmetric PSD A per row. Row i stops
    when ||r_i|| <= max(rtol_i ||b_i||, atol_i), after ``stall_iters``
    non-improving iterations at a proven floor, on breakdown, or on a
    non-finite residual. See the JAX docstring for the reasoning behind each
    rule; the decisions here are the same, step for step.

    Returns (x, CGInfo): the best-residual iterate, or each row's last
    iterate when ``track_best=False``."""
    dtype, dev = b.dtype, b.device
    batch = b.shape[0]
    if x0 is None:
        x0 = torch.zeros_like(b)
    if precond is None:
        precond = lambda v: v  # noqa: E731
    rtol = torch.as_tensor(rtol, dtype=dtype, device=dev).broadcast_to((batch,))
    atol = torch.as_tensor(atol, dtype=dtype, device=dev).broadcast_to((batch,))
    tiny = torch.finfo(dtype).tiny
    eps = torch.finfo(dtype).eps

    b_norm = torch.sqrt(_dot(b, b))
    stop = torch.maximum(rtol * b_norm, atol)

    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    best = torch.sqrt(_dot(r, r))
    active = best > stop
    stall = torch.zeros((batch,), dtype=torch.int32, device=dev)
    bx = x0
    i = 0
    syncs = 0
    while i < maxiter:
        forced = i < min_iter
        if not forced:
            syncs += 1
            if not decide(active.any()):
                break
        act = torch.ones_like(active) if forced else active
        ap = matvec(p)
        pap = _dot(p, ap)
        # rows whose p and Ap are numerically orthogonal take no step
        breakdown = pap <= 1e-16 * torch.sqrt(_dot(p, p) * _dot(ap, ap))
        alpha = torch.where(breakdown, torch.zeros((), dtype=dtype, device=dev),
                            rz / torch.clamp(pap, min=tiny))
        m = act[:, None].to(dtype)
        x = x + m * alpha[:, None] * p
        r = r - m * alpha[:, None] * ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = torch.where(act[:, None], z + beta[:, None] * p, p)
        res = torch.sqrt(_dot(r, r))
        improved = res < 0.999 * best
        # forced iterations take the current iterate unconditionally
        take = (res < best) & torch.isfinite(res)
        if forced:
            take = torch.ones_like(take)
        bx = torch.where(take[:, None], x, bx)
        best = res if forced else torch.minimum(best, res)
        engaged = best < stall_engage * b_norm
        stall = torch.where(~improved & engaged, stall + 1, torch.zeros_like(stall))
        stall_hit = stall >= stall_iters
        if stall_floor_check:
            # prove the floor before freezing: one extra matvec, only when
            # some active row's counter fired
            syncs += 1
            if decide((stall_hit & act).any()):
                ax = matvec(x)
                true_r = b - ax
                true_res = torch.sqrt(_dot(true_r, true_r))
                ax_norm = torch.sqrt(_dot(ax, ax))
                at_floor = true_res <= 10.0 * eps * (ax_norm + b_norm)
                decoupled = torch.abs(true_res - res) > 0.5 * true_res
                floor = at_floor | decoupled
            else:
                floor = torch.ones_like(stall_hit)
            stall = torch.where(stall_hit & ~floor, torch.zeros_like(stall), stall)
            frozen = stall_hit & floor
        else:
            frozen = stall_hit
        active = act & (res > stop) & ~frozen & torch.isfinite(res) & ~breakdown
        rz = rz_new
        i += 1

    ret_res = best if track_best else torch.sqrt(_dot(r, r))
    return (bx if track_best else x), CGInfo(
        niter=i, residual_norm=ret_res, optimal=ret_res <= stop, host_syncs=syncs)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       precond: Optional[Callable] = None, rtol=1e-3, atol=0.0, maxiter: int = 1000):
    """Single-system CG on an arbitrarily-shaped b; matvec keeps b's shape."""
    shape = b.shape

    def flat(fn):
        return lambda v: fn(v.reshape(shape)).reshape(1, -1)

    x, info = cg_batch(flat(matvec), b.reshape(1, -1),
                       x0=None if x0 is None else x0.reshape(1, -1),
                       precond=None if precond is None else flat(precond),
                       rtol=rtol, atol=atol, maxiter=maxiter)
    return x.reshape(shape), info


class _SymmetricSolve(torch.autograd.Function):
    """x = A^-1 b by CG; the cotangent of b is A^-1 g, a second CG solve
    (A symmetric, so the transposed solve is the solve itself)."""

    @staticmethod
    def forward(ctx, b, matvec, rtol, maxiter):
        ctx.matvec, ctx.rtol, ctx.maxiter = matvec, rtol, maxiter
        return cg(matvec, b.detach(), rtol=rtol, maxiter=maxiter)[0]

    @staticmethod
    def backward(ctx, g):
        return cg(ctx.matvec, g, rtol=ctx.rtol, maxiter=ctx.maxiter)[0], None, None, None


def cg_solve(matvec: Callable, b: torch.Tensor, rtol=1e-5, maxiter: int = 1000) -> torch.Tensor:
    """Differentiable symmetric solve A x = b, implicitly differentiated as
    ``lax.custom_linear_solve(symmetric=True)`` is: the gradient of b is one
    more CG solve against the cotangent, and tensors that ``matvec`` closes
    over get -A^-1 (dA x) through the second term below, whose value is
    exactly 0 (CG on b = 0 returns its zero start)."""
    x = _SymmetricSolve.apply(b, matvec, rtol, maxiter)
    if not torch.is_grad_enabled():
        return x
    with torch.enable_grad():
        ax = matvec(x.detach())
    if not ax.requires_grad:
        return x
    return x - _SymmetricSolve.apply(ax - ax.detach(), matvec, rtol, maxiter)
