"""Analytic Gaussian-mixture diffusion testbed.

Counterpart of ``free_hunch_tpu/analysis/gmm.py``. A Gaussian mixture
convolved with Gaussian noise stays a Gaussian mixture, so every quantity
the Free Hunch machinery estimates has a closed form here: the exact
score, its Hessian, the denoiser mean and covariance (Tweedie), the exact
posterior given a linear measurement, and the probability-flow ODE with
the exact score. So the covariance estimator and the whole guidance
pipeline can be checked with no trained network.

The analytic functions work in float64 (``GaussianMixture`` converts its
tensors) and return the dtype of ``x``; densities use
``torch.logsumexp``, triangular solves ``torch.linalg.solve_triangular``.
Everything is batch-first over the leading axes of ``x`` (..., d).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """weights (K,), means (K, d), covs (K, d, d): the data distribution
    p_0, held in float64."""
    weights: torch.Tensor
    means: torch.Tensor
    covs: torch.Tensor

    def __post_init__(self):
        for name in ("weights", "means", "covs"):
            object.__setattr__(self, name, torch.as_tensor(getattr(self, name)).to(_F64))

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def to(self, device) -> "GaussianMixture":
        return GaussianMixture(self.weights.to(device), self.means.to(device),
                               self.covs.to(device))

    def at_noise_level(self, sigma) -> "GaussianMixture":
        """p_t = p_0 * N(0, sigma^2 I): the same mixture, covariances inflated."""
        eye = torch.eye(self.dim, dtype=_F64, device=self.covs.device)
        return GaussianMixture(self.weights, self.means, self.covs + float(sigma) ** 2 * eye)

    # --- densities -----------------------------------------------------------

    def _comp_stats(self):
        chol = torch.linalg.cholesky(self.covs)
        logdet = 2 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        return chol, logdet

    def _maha(self, x: torch.Tensor):
        """Per-component squared Mahalanobis distances (..., K) and the
        log-determinants (K,)."""
        chol, logdet = self._comp_stats()
        diff = x.to(_F64)[..., None, :] - self.means                    # (..., K, d)
        z = torch.linalg.solve_triangular(chol, diff[..., None], upper=False)[..., 0]
        return torch.sum(z**2, dim=-1), logdet

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., d) -> (...), float64."""
        maha, logdet = self._maha(x)
        log_comp = torch.log(self.weights) - 0.5 * (maha + logdet + self.dim * math.log(2 * math.pi))
        return torch.logsumexp(log_comp, dim=-1)

    def responsibilities(self, x: torch.Tensor) -> torch.Tensor:
        maha, logdet = self._maha(x)
        return torch.softmax(torch.log(self.weights) - 0.5 * (maha + logdet), dim=-1)

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        """Samples (*shape, d) drawn from ``generator`` (a CPU generator:
        the component, then the normal draw), on the mixture's device."""
        shape = tuple(shape)
        comp = torch.multinomial(self.weights.cpu(), int(np.prod(shape, dtype=np.int64)),
                                 replacement=True, generator=generator).reshape(shape)
        eps = torch.randn(shape + (self.dim,), generator=generator, dtype=_F64)
        comp, eps = comp.to(self.means.device), eps.to(self.means.device)
        chol = torch.linalg.cholesky(self.covs)
        return self.means[comp] + torch.einsum("...ij,...j->...i", chol[comp], eps)


# ---------------------------------------------------------------------------
# Exact diffusion quantities
# ---------------------------------------------------------------------------

def _component_scores(gmm: GaussianMixture, x: torch.Tensor, sigma):
    """(responsibilities (..., K), per-component scores (..., K, d), the
    inflated precisions (K, d, d)) of p_sigma at x."""
    pt = gmm.at_noise_level(sigma)
    r = pt.responsibilities(x)
    inv = torch.linalg.inv(pt.covs)
    diff = x.to(_F64)[..., None, :] - pt.means
    return r, -torch.einsum("kij,...kj->...ki", inv, diff), inv


def score(gmm: GaussianMixture, x: torch.Tensor, sigma) -> torch.Tensor:
    """grad_x log p_sigma(x), exact."""
    r, g_k, _ = _component_scores(gmm, x, sigma)
    return torch.sum(r[..., None] * g_k, dim=-2).to(x.dtype)


def score_hessian(gmm: GaussianMixture, x: torch.Tensor, sigma) -> torch.Tensor:
    """grad^2_x log p_sigma(x), exact: (..., d, d)."""
    r, g_k, inv = _component_scores(gmm, x, sigma)
    g = torch.sum(r[..., None] * g_k, dim=-2)
    h = -torch.einsum("...k,kij->...ij", r, inv)
    h = h + torch.sum(r[..., None, None] * g_k[..., :, None] * g_k[..., None, :], dim=-3)
    h = h - g[..., :, None] * g[..., None, :]
    return h.to(x.dtype)


def denoiser_mean(gmm: GaussianMixture, x: torch.Tensor, sigma) -> torch.Tensor:
    """E[x_0 | x_t] = x + sigma^2 score (Tweedie)."""
    return (x.to(_F64) + float(sigma) ** 2 * score(gmm, x.to(_F64), sigma)).to(x.dtype)


def denoiser_covariance(gmm: GaussianMixture, x: torch.Tensor, sigma) -> torch.Tensor:
    """Cov[x_0 | x_t] = sigma^2 (I + sigma^2 H), exact."""
    s2 = float(sigma) ** 2
    h = score_hessian(gmm, x.to(_F64), sigma)
    eye = torch.eye(gmm.dim, dtype=_F64, device=h.device)
    return (s2 * (eye + s2 * h)).to(x.dtype)


def posterior_given_y(gmm: GaussianMixture, A, y, sigma_y: float) -> GaussianMixture:
    """The exact posterior p(x0 | y = A x0 + n), n ~ N(0, sigma_y^2 I):
    each component conditioned as a Gaussian, the weights reweighted by
    each component's evidence N(y; A mu_k, S_k)."""
    A = torch.as_tensor(A).to(device=gmm.means.device, dtype=_F64)
    y = torch.as_tensor(y).to(device=gmm.means.device, dtype=_F64)
    m = y.shape[-1]
    covs, means, w = gmm.covs, gmm.means, gmm.weights
    eye = torch.eye(m, dtype=_F64, device=A.device)
    S = torch.einsum("ij,kjl,ml->kim", A, covs, A) + float(sigma_y) ** 2 * eye
    CAt = torch.einsum("kij,jm->kim", covs, A.T)                     # covs_k A^T
    gain = torch.einsum("kim,kmn->kin", CAt, torch.linalg.inv(S))    # Kalman gain
    resid = y[None, :] - torch.einsum("ij,kj->ki", A, means)
    post_means = means + torch.einsum("kin,kn->ki", gain, resid)
    post_covs = covs - torch.einsum("kin,kjn->kij", gain, CAt)
    post_covs = 0.5 * (post_covs + post_covs.transpose(-1, -2))
    chol = torch.linalg.cholesky(S)
    z = torch.linalg.solve_triangular(chol, resid[..., None], upper=False)[..., 0]
    logdet = 2 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    logw = torch.log(w) - 0.5 * (torch.sum(z**2, dim=-1) + logdet)
    return GaussianMixture(torch.softmax(logw, dim=-1), post_means, post_covs)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def sample_ode(gmm: GaussianMixture, n: int, generator: torch.Generator,
               sigma_max: float = 80.0, sigma_min: float = 1e-3, num_steps: int = 100,
               solver: str = "heun") -> torch.Tensor:
    """The probability-flow ODE with the exact score on a geometric sigma
    grid, from sigma_max times a normal draw of ``generator``; float64."""
    sigmas = np.geomspace(sigma_max, sigma_min, num_steps + 1)
    x = sigma_max * torch.randn((n, gmm.dim), generator=generator, dtype=_F64).to(
        gmm.means.device)
    for s_cur, s_next in zip(sigmas[:-1], sigmas[1:]):
        d = -s_cur * score(gmm, x, s_cur)
        x_e = x + (s_next - s_cur) * d
        if solver == "heun":
            d2 = -s_next * score(gmm, x_e, s_next)
            x = x + (s_next - s_cur) * 0.5 * (d + d2)
        else:
            x = x_e
    return x


def guided_denoiser_fn(gmm: GaussianMixture):
    """The analytic (mean, var) 'network' with the framework's denoiser
    contract, so the whole guidance stack runs with no checkpoint."""
    def denoise(x_flat, sigma):
        s2 = float(sigma) ** 2
        return denoiser_mean(gmm, x_flat, sigma), torch.full_like(x_flat, s2 / (1 + s2))
    return denoise
