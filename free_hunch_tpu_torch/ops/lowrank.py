"""Batched fixed-capacity symmetric low-rank-plus-diagonal matrices:
``diag(a) + U M U^T``, one per batch row.

Counterpart of ``free_hunch_tpu/ops/lowrank.py``, where every function acts
on one sample and the batch comes from ``vmap``. Here the leading batch axis
is written out:

* ``diag`` (B, d); ``Ut`` (B, K, d), the columns of U stored as rows (rows
  >= k are zero); ``M`` (B, K, K) symmetric with the inactive block equal to
  the identity; ``k`` (B,) int64 active column counts, which may differ
  between rows (a BFGS pair is skipped per row).
* Matmuls run in full f32 (TF32 off, see ``free_hunch_tpu_torch.use_full_f32``):
  the JAX package runs this algebra at ``Precision.HIGHEST``.
* ``append_pair`` writes at each row's own index ``k`` with plain indexing;
  ``compress`` runs only when some row would overflow its capacity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from free_hunch_tpu_torch import check_full_f32


class LowRank(NamedTuple):
    """Per-row symmetric d x d matrices ``diag(diag) + Ut^T M Ut``."""
    diag: torch.Tensor   # (B, d)
    Ut: torch.Tensor     # (B, K, d)
    M: torch.Tensor      # (B, K, K)
    k: torch.Tensor      # (B,) int64

    @property
    def capacity(self) -> int:
        return self.Ut.shape[-2]


def init(diag: torch.Tensor, capacity: int) -> LowRank:
    """Fresh state from a (B, d) diagonal."""
    b, d = diag.shape
    return LowRank(
        diag=diag,
        Ut=torch.zeros((b, capacity, d), dtype=diag.dtype, device=diag.device),
        M=torch.eye(capacity, dtype=diag.dtype, device=diag.device).expand(
            b, capacity, capacity).clone(),
        k=torch.zeros((b,), dtype=torch.int64, device=diag.device),
    )


def matvec(rep: LowRank, v: torch.Tensor) -> torch.Tensor:
    """(diag(a) + U M U^T) @ v per row, v of shape (B, d)."""
    check_full_f32(v)
    t = torch.bmm(rep.Ut, v.unsqueeze(-1))
    t = torch.bmm(rep.M, t)
    core = torch.bmm(rep.Ut.transpose(1, 2), t).squeeze(-1)
    return rep.diag * v + core


def diag_of(rep: LowRank) -> torch.Tensor:
    """Exact diagonal: a_i + sum_j Ut_ji (M Ut)_ji."""
    return rep.diag + torch.einsum("bkd,bkd->bd", rep.Ut, torch.bmm(rep.M, rep.Ut))


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def _inv_sym(a: torch.Tensor) -> torch.Tensor:
    """Inverse of (possibly indefinite) symmetric k x k matrices."""
    return _sym(torch.linalg.inv(a))


def inverse(rep: LowRank) -> LowRank:
    """Woodbury: (D + U M U^T)^-1 = D^-1 + (D^-1 U) Mi (D^-1 U)^T with
    Mi = -(M^-1 + U^T D^-1 U)^-1; inactive columns stay zero."""
    check_full_f32(rep.Ut)
    diag_inv = 1.0 / rep.diag
    Uit = rep.Ut * diag_inv[:, None, :]
    inner = _inv_sym(rep.M) + _sym(torch.bmm(rep.Ut, Uit.transpose(1, 2)))
    Mi = -_inv_sym(inner)
    return LowRank(diag=diag_inv, Ut=Uit, M=Mi, k=rep.k)


def shift_diag(rep: LowRank, c) -> LowRank:
    """Representation of (A + c I)."""
    return rep._replace(diag=rep.diag + c)


def scale(rep: LowRank, alpha) -> LowRank:
    """Representation of (alpha * A)."""
    return LowRank(diag=rep.diag * alpha, Ut=rep.Ut, M=rep.M * alpha, k=rep.k)


def affine(rep: LowRank, alpha, beta) -> LowRank:
    """Representation of (alpha * A + beta * I)."""
    return LowRank(diag=rep.diag * alpha + beta, Ut=rep.Ut, M=rep.M * alpha, k=rep.k)


def dense(rep: LowRank) -> torch.Tensor:
    """Materialise the (B, d, d) matrices (tests / tiny dims only)."""
    return torch.diag_embed(rep.diag) + rep.Ut.transpose(1, 2) @ rep.M @ rep.Ut


def compress(rep: LowRank, target_rank: int) -> LowRank:
    """Optimal rank truncation of the low-rank part per row: keep the
    ``target_rank`` eigen-directions of U M U^T with the largest |eigenvalue|
    (with G = U^T U = L L^T and L^T M L = Q Lam Q^T, U M U^T = W Lam W^T
    with orthonormal W = U L^-T Q)."""
    check_full_f32(rep.Ut)
    K = rep.capacity
    dtype, dev = rep.diag.dtype, rep.diag.device
    eye = torch.eye(K, dtype=dtype, device=dev)
    G = _sym(torch.bmm(rep.Ut, rep.Ut.transpose(1, 2)))
    jitter = (G.diagonal(dim1=-2, dim2=-1).sum(-1) / K) * 1e-7 + 1e-30
    L = torch.linalg.cholesky(G + jitter[:, None, None] * eye)
    H = _sym(L.transpose(1, 2) @ rep.M @ L)
    lam, Q = torch.linalg.eigh(H)
    Wt = Q.transpose(1, 2) @ torch.linalg.solve_triangular(L, rep.Ut, upper=False)
    order = torch.argsort(-lam.abs(), dim=-1, stable=True)
    lam_sorted = torch.gather(lam, -1, order)
    Wt_sorted = torch.gather(Wt, 1, order[:, :, None].expand_as(Wt))
    tiny = torch.finfo(dtype).tiny
    strong = lam_sorted.abs() > 1e-6 * lam_sorted[:, :1].abs() + tiny
    col_mask = (torch.arange(K, device=dev) < target_rank)[None, :] & strong
    k_new = col_mask.sum(-1).to(torch.int64)
    Ut_new = torch.where(col_mask[:, :, None], Wt_sorted, torch.zeros((), dtype=dtype, device=dev))
    M_new = torch.diag_embed(torch.where(col_mask, lam_sorted,
                                         torch.ones((), dtype=dtype, device=dev)))
    return LowRank(diag=rep.diag, Ut=Ut_new, M=M_new, k=k_new)


def select(mask: torch.Tensor, a: LowRank, b: LowRank) -> LowRank:
    """Row-wise ``a if mask else b``."""
    return LowRank(diag=torch.where(mask[:, None], a.diag, b.diag),
                   Ut=torch.where(mask[:, None, None], a.Ut, b.Ut),
                   M=torch.where(mask[:, None, None], a.M, b.M),
                   k=torch.where(mask, a.k, b.k))


def append_pair(rep: LowRank, col_a: torch.Tensor, w_a: torch.Tensor,
                col_b: torch.Tensor, w_b: torch.Tensor) -> LowRank:
    """Representation of (A + w_a a a^T + w_b b b^T) per row.

    Columns are unit-normalised (norms absorbed into the inner weights). Rows
    that would overflow their capacity are first compressed to their best
    (capacity - 2)-rank approximation. One host sync decides whether any row
    needs that."""
    K = rep.capacity
    need = rep.k + 2 > K
    if bool(need.any()):
        rep = select(need, compress(rep, K - 2), rep)
    k = rep.k
    tiny = torch.finfo(col_a.dtype).tiny

    def norm_absorb(col, w):
        n2 = torch.sum(col * col, dim=-1)
        nrm = torch.sqrt(torch.clamp(n2, min=tiny))
        return col / nrm[:, None], w * n2

    ca, wa = norm_absorb(col_a, w_a)
    cb, wb = norm_absorb(col_b, w_b)
    rows = torch.arange(k.shape[0], device=k.device)
    Ut = rep.Ut.clone()
    Ut[rows, k] = ca
    Ut[rows, k + 1] = cb
    # the inactive block of M is diagonal: overwriting two diagonal entries
    # is a complete update
    M = rep.M.clone()
    M[rows, k, k] = wa
    M[rows, k + 1, k + 1] = wb
    return LowRank(diag=rep.diag, Ut=Ut, M=M, k=k + 2)
