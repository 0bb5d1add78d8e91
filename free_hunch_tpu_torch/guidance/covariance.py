"""Online denoiser-covariance estimation (the Free Hunch core), batched.

Counterpart of ``free_hunch_tpu/guidance/covariance.py`` (:41-222). The
state is one ``LowRank`` with a leading batch axis: the denoiser covariance
Sigma_0 of each sample in the chosen orthogonal basis. Noise levels
(``sigma``) are host scalars. All vectors are flattened (B, d) in the
transform basis. Every function takes ``reduce`` (``ops/lowrank.py``): the
identity for a whole state, the model group's all_reduce for a d-sharded
one (``parallel/sharded_cov.py``), whose vectors are then this rank's
d-block.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from free_hunch_tpu_torch.ops import lowrank
from free_hunch_tpu_torch.ops.lowrank import LowRank, Reduce, whole


class CovParams(NamedTuple):
    """Static hyper-parameters of the covariance model (see the JAX
    ``CovParams`` for the reasoning behind each guard)."""
    project_to_diagonal: bool = False
    # skip BFGS pairs with non-positive secant curvature (keeps Sigma_0 PSD)
    curvature_guard: bool = True
    # skip pairs the state already explains: ||de - S dx|| <= tau max(...)
    secant_novelty_min: float = 0.02


def init_state(init_denoiser_variance: torch.Tensor, batch: int, data_dim: int,
               capacity: int) -> LowRank:
    """Fresh state Sigma_0 = diag(init_denoiser_variance) for every sample;
    the variance is a scalar or a (d,) vector, and sets dtype and device."""
    v = torch.as_tensor(init_denoiser_variance)
    diag = v.broadcast_to((batch, data_dim)).clone()
    return lowrank.init(diag, capacity)


def hessian(cov: LowRank, sigma) -> LowRank:
    """H = (Sigma_0 - sigma^2 I) / sigma^4."""
    return lowrank.affine(cov, 1.0 / sigma**4, -1.0 / sigma**2)


def cov_matvec(cov: LowRank, v: torch.Tensor, reduce: Reduce = whole) -> torch.Tensor:
    return lowrank.matvec(cov, v, reduce)


def inv_cov_matvec(cov: LowRank, v: torch.Tensor, reduce: Reduce = whole) -> torch.Tensor:
    return lowrank.matvec(lowrank.inverse(cov, reduce), v, reduce)


def hessian_matvec(cov: LowRank, sigma, v: torch.Tensor,
                   reduce: Reduce = whole) -> torch.Tensor:
    return lowrank.matvec(hessian(cov, sigma), v, reduce)


def inv_hessian_matvec(cov: LowRank, sigma, v: torch.Tensor,
                       reduce: Reduce = whole) -> torch.Tensor:
    return lowrank.matvec(lowrank.inverse(hessian(cov, sigma), reduce), v, reduce)


def time_update(cov: LowRank, sigma, sigma_next, reduce: Reduce = whole) -> LowRank:
    """Move Sigma_0 from noise level sigma to sigma_next:
    Sigma^-1(s') = Sigma^-1(s) + (s'^-2 - s^-2) I."""
    inv = lowrank.inverse(cov, reduce)
    inv = lowrank.shift_diag(inv, 1.0 / sigma_next**2 - 1.0 / sigma**2)
    return lowrank.inverse(inv, reduce)


def transport_score(cov: LowRank, cov_next: LowRank, sigma, sigma_next,
                    x: torch.Tensor, score: torch.Tensor, reduce: Reduce = whole
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Telescoped analytic transport: score' = (s^2/s'^2) (I + a Sigma)^-1
    score with a = 1/s'^2 - 1/s^2, mean' = x + s'^2 score'. The (p - s^2)
    singularity of the two-operator form cancels algebraically (JAX
    docstring); ``cov_next`` is kept for signature parity."""
    del cov_next
    a = 1.0 / sigma_next**2 - 1.0 / sigma**2
    op = lowrank.inverse(lowrank.affine(cov, a, 1.0), reduce)
    score_next = (sigma**2 / sigma_next**2) * lowrank.matvec(op, score, reduce)
    mean_next = x + sigma_next**2 * score_next
    return mean_next, score_next


def transport_score_two_inverse(cov: LowRank, cov_next: LowRank, sigma, sigma_next,
                                x: torch.Tensor, score: torch.Tensor, reduce: Reduce = whole
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's literal H(s') H(s)^-1 transport (A/B fidelity mode)."""
    del cov_next
    ih = lowrank.inverse(hessian(cov, sigma), reduce)
    ih_next = lowrank.shift_diag(ih, -(sigma_next**2 - sigma**2))
    h_next = lowrank.inverse(ih_next, reduce)
    score_next = lowrank.matvec(h_next, lowrank.matvec(ih, score, reduce), reduce)
    mean_next = x + sigma_next**2 * score_next
    return mean_next, score_next


def space_update(cov: LowRank, sigma, x: torch.Tensor, x_next: torch.Tensor,
                 mean_at_x: torch.Tensor, mean_at_x_next: torch.Tensor,
                 params: CovParams = CovParams(), reduce: Reduce = whole,
                 resets: Optional[torch.Tensor] = None) -> LowRank:
    """BFGS rank-2 update per row after observing the denoiser at two points
    with the same sigma:
    Sigma <- Sigma - (S dx)(S dx)^T / (dx^T S dx) + de de^T / (dx^T de),
    with de = sigma^2 (D(x') - D(x)), dx = x' - x. Rows whose pair fails the
    guards keep their state. ``resets``, where given, is a (B,) int64 count
    to which each row whose state the append's compress reset adds one, in
    place (``lowrank.append_pair``)."""
    dtype = x.dtype
    dx = x_next - x
    de = sigma**2 * (mean_at_x_next - mean_at_x)
    sv = lowrank.matvec(cov, dx, reduce)
    tiny = torch.finfo(dtype).tiny
    # the inner products over d, reduced together
    dxsv, dxde, res2, dede, svsv = reduce(torch.stack([
        torch.sum(dx * sv, dim=-1), torch.sum(dx * de, dim=-1),
        torch.sum((de - sv) ** 2, dim=-1), torch.sum(de * de, dim=-1),
        torch.sum(sv * sv, dim=-1)]))
    if params.curvature_guard:
        valid = (dxde > tiny) & (dxsv > tiny)
        if params.secant_novelty_min > 0:
            floor2 = params.secant_novelty_min ** 2 * torch.maximum(dede, svsv)
            valid = valid & (res2 > floor2)
    else:
        valid = (dxde.abs() > tiny) & (dxsv.abs() > tiny)
    one = torch.ones((), dtype=dtype, device=x.device)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    c_neg = torch.where(valid, -1.0 / torch.where(valid, dxsv, one), zero)
    gamma = torch.where(valid, 1.0 / torch.where(valid, dxde, one), zero)
    if params.project_to_diagonal:
        new_diag = cov.diag + gamma[:, None] * de * de + c_neg[:, None] * sv * sv
        return cov._replace(diag=new_diag)
    reset = None if resets is None else torch.zeros_like(resets)
    appended = lowrank.append_pair(cov, sv, c_neg, de, gamma, reduce, reset)
    if resets is not None:
        resets += reset * valid
    return lowrank.select(valid, appended, cov)
