"""Guided posterior sampling on the analytic GMM testbed.

Counterpart of ``free_hunch_tpu/analysis/gmm_guided.py``: the production
stack on the toy problem. The exact GMM denoiser takes the framework's
(mean, var) contract on images of shape (B, d, 1, 1), the measurement is
a coordinate mask (inpainting), and the port's ``FreeHunch`` with
``prepare_schedule`` and ``sample_loop`` samples the posterior, which
``posterior_given_y`` gives exactly.

As in ``analysis/linear_gaussian.py``, ``sample_gmm_posterior_from`` runs
on an explicit initial noise and ``sample_gmm_posterior`` draws it from a
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from free_hunch_tpu_torch import randn, resolve_device
from free_hunch_tpu_torch.analysis import gmm as G
from free_hunch_tpu_torch.guidance.mechanisms import FreeHunch
from free_hunch_tpu_torch.operators import get_operator
from free_hunch_tpu_torch.samplers.edm import prepare_schedule, sample_loop

SIGMA_MAX = 20.0


def gmm_image_denoiser(gmm: G.GaussianMixture):
    """The exact GMM denoiser on (B, d, 1, 1) images."""
    d = gmm.dim

    def denoise(x, sigma):
        flat = x.reshape(x.shape[0], d)
        mean = G.denoiser_mean(gmm, flat, sigma)
        s2 = float(sigma) ** 2
        return mean.reshape(x.shape), torch.full_like(x, s2 / (1 + s2))

    return denoise


def _mask_rows(observed_mask) -> np.ndarray:
    return np.where(np.asarray(observed_mask, np.float32) > 0)[0]


def gmm_posterior(gmm: G.GaussianMixture, observed_mask, y_value, sigma_y: float
                  ) -> G.GaussianMixture:
    """The exact posterior of ``sample_gmm_posterior``'s problem: y is the
    observed coordinates of ``y_value``."""
    rows = _mask_rows(observed_mask)
    A = np.zeros((rows.size, gmm.dim))
    A[np.arange(rows.size), rows] = 1.0
    return G.posterior_given_y(gmm, A, np.asarray(y_value, np.float64)[rows], sigma_y)


def sample_gmm_posterior_from(gmm: G.GaussianMixture, observed_mask, y_value,
                              sigma_y: float, noise: torch.Tensor, *, num_steps: int = 30,
                              mechanism_kwargs: Optional[dict] = None):
    """Sample p(x0 | y = mask * x0 + noise) from the initial ``noise``
    (n, d, 1, 1) on its device; y = mask * y_value on every sample. Returns
    (x (n, d, 1, 1), sample_loop's diagnostics)."""
    d = gmm.dim
    dev = noise.device
    n = noise.shape[0]
    mask = np.asarray(observed_mask, np.float32)
    op = get_operator(name="inpainting", sigma_s=sigma_y, mask=mask.reshape(1, d, 1, 1),
                      in_shape=(1, d, 1, 1), device=dev)
    mkw = dict(cond_scaling=1.0, clip_x0_mean=False, init_denoiser_variance=1.0, data_dim=d,
               cov_capacity=16, image_base_covariance="identity",
               # space updates only in the mid-sigma window, as the paper
               # configures (BFGS pairs at tiny sigma are noise-dominated)
               space_step_update_lower_threshold=1.0, space_step_update_threshold=10.0,
               denoiser_mean_error_threshold=1e9, max_rtol=1e-4,
               transport_mean_bound=10.0, guidance_update_bound=20.0, cg_maxiter=50)
    mkw.update(mechanism_kwargs or {})
    mech = FreeHunch(forward_operator=op, init_noise_variance=SIGMA_MAX**2, **mkw)
    xs, sigma0_scaled = prepare_schedule(
        round_sigma=lambda s, return_index=False: s, net_sigma_min=1e-3,
        net_sigma_max=SIGMA_MAX, num_steps=num_steps, solver="heun", discretization="edm",
        schedule="linear", scaling="none", sigma_min=2e-3, sigma_max=SIGMA_MAX)
    y_img = torch.as_tensor((mask * np.asarray(y_value, np.float32)).reshape(1, d, 1, 1),
                            device=dev).expand(n, d, 1, 1).contiguous()
    x, _, diag = sample_loop(gmm_image_denoiser(gmm.to(dev)), mech, noise, y_img, xs,
                             sigma0_scaled=sigma0_scaled, collect_diagnostics=True)
    return x, diag


def sample_gmm_posterior(gmm: G.GaussianMixture, observed_mask, y_value, sigma_y: float, *,
                         n: int = 512, num_steps: int = 30,
                         generator: Optional[torch.Generator] = None,
                         mechanism_kwargs: Optional[dict] = None, device=None
                         ) -> Tuple[np.ndarray, G.GaussianMixture]:
    """Sample the posterior on ``device`` (default CUDA) from a normal draw
    of ``generator`` (default: a CPU generator seeded 0). Returns (samples
    (n, d) as host numpy, the exact posterior mixture)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    noise = randn((n, gmm.dim, 1, 1), gen, device=resolve_device(device))
    x, _ = sample_gmm_posterior_from(gmm, observed_mask, y_value, sigma_y, noise,
                                     num_steps=num_steps, mechanism_kwargs=mechanism_kwargs)
    return x.reshape(n, gmm.dim).cpu().numpy(), gmm_posterior(gmm, observed_mask, y_value,
                                                              sigma_y)
