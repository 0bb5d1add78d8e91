"""Online denoiser-covariance estimation (the Free Hunch core), batched.

Counterpart of ``free_hunch_tpu/guidance/covariance.py`` (:41-222). The
state is one ``LowRank`` with a leading batch axis: the denoiser covariance
Sigma_0 of each sample in the chosen orthogonal basis. Noise levels
(``sigma``) are host scalars. All vectors are flattened (B, d) in the
transform basis.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from free_hunch_tpu_torch.ops import lowrank
from free_hunch_tpu_torch.ops.lowrank import LowRank


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


def cov_matvec(cov: LowRank, v: torch.Tensor) -> torch.Tensor:
    return lowrank.matvec(cov, v)


def inv_cov_matvec(cov: LowRank, v: torch.Tensor) -> torch.Tensor:
    return lowrank.matvec(lowrank.inverse(cov), v)


def hessian_matvec(cov: LowRank, sigma, v: torch.Tensor) -> torch.Tensor:
    return lowrank.matvec(hessian(cov, sigma), v)


def inv_hessian_matvec(cov: LowRank, sigma, v: torch.Tensor) -> torch.Tensor:
    return lowrank.matvec(lowrank.inverse(hessian(cov, sigma)), v)


def time_update(cov: LowRank, sigma, sigma_next) -> LowRank:
    """Move Sigma_0 from noise level sigma to sigma_next:
    Sigma^-1(s') = Sigma^-1(s) + (s'^-2 - s^-2) I."""
    inv = lowrank.inverse(cov)
    inv = lowrank.shift_diag(inv, 1.0 / sigma_next**2 - 1.0 / sigma**2)
    return lowrank.inverse(inv)


def transport_score(cov: LowRank, cov_next: LowRank, sigma, sigma_next,
                    x: torch.Tensor, score: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Telescoped analytic transport: score' = (s^2/s'^2) (I + a Sigma)^-1
    score with a = 1/s'^2 - 1/s^2, mean' = x + s'^2 score'. The (p - s^2)
    singularity of the two-operator form cancels algebraically (JAX
    docstring); ``cov_next`` is kept for signature parity."""
    del cov_next
    a = 1.0 / sigma_next**2 - 1.0 / sigma**2
    op = lowrank.inverse(lowrank.affine(cov, a, 1.0))
    score_next = (sigma**2 / sigma_next**2) * lowrank.matvec(op, score)
    mean_next = x + sigma_next**2 * score_next
    return mean_next, score_next


def transport_score_two_inverse(cov: LowRank, cov_next: LowRank, sigma, sigma_next,
                                x: torch.Tensor, score: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's literal H(s') H(s)^-1 transport (A/B fidelity mode)."""
    del cov_next
    ih = lowrank.inverse(hessian(cov, sigma))
    ih_next = lowrank.shift_diag(ih, -(sigma_next**2 - sigma**2))
    h_next = lowrank.inverse(ih_next)
    score_next = lowrank.matvec(h_next, lowrank.matvec(ih, score))
    mean_next = x + sigma_next**2 * score_next
    return mean_next, score_next


def space_update(cov: LowRank, sigma, x: torch.Tensor, x_next: torch.Tensor,
                 mean_at_x: torch.Tensor, mean_at_x_next: torch.Tensor,
                 params: CovParams = CovParams()) -> LowRank:
    """BFGS rank-2 update per row after observing the denoiser at two points
    with the same sigma:
    Sigma <- Sigma - (S dx)(S dx)^T / (dx^T S dx) + de de^T / (dx^T de),
    with de = sigma^2 (D(x') - D(x)), dx = x' - x. Rows whose pair fails the
    guards keep their state."""
    dtype = x.dtype
    dx = x_next - x
    de = sigma**2 * (mean_at_x_next - mean_at_x)
    sv = lowrank.matvec(cov, dx)
    tiny = torch.finfo(dtype).tiny
    dxsv = torch.sum(dx * sv, dim=-1)
    dxde = torch.sum(dx * de, dim=-1)
    if params.curvature_guard:
        valid = (dxde > tiny) & (dxsv > tiny)
        if params.secant_novelty_min > 0:
            res2 = torch.sum((de - sv) ** 2, dim=-1)
            floor2 = params.secant_novelty_min ** 2 * torch.maximum(
                torch.sum(de * de, dim=-1), torch.sum(sv * sv, dim=-1))
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
    return lowrank.select(valid, lowrank.append_pair(cov, sv, c_neg, de, gamma), cov)
