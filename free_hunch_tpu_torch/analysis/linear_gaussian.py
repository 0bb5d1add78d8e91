"""Image-scale linear-Gaussian oracle.

Counterpart of ``free_hunch_tpu/analysis/linear_gaussian.py``. A Gaussian
prior that is diagonal in the DCT basis, the production
``image_base_covariance='dct_diagonal'`` configuration, has a closed-form
denoiser, denoiser covariance and measurement posterior. So the whole
guided pipeline (the EDM Heun loop, the Free Hunch covariance state, the
tailored CG and the FFT measurement operators, in any guidance-gradient
mode) can be held to the exact posterior moments at image scale.

Math (x in R^d, prior x ~ N(0, B diag(v) B^T), B the orthonormal
inverse-DCT map):
  denoiser      x0(x_t, s) = B diag(v/(v+s^2)) B^T x_t
  denoiser cov  Sigma_0(s) = B diag(s^2 v/(v+s^2)) B^T
  posterior     Sigma_post = (A^T A/s_y^2 + B diag(1/v) B^T)^-1,
                mu_post    = Sigma_post A^T y / s_y^2

The sampler is split in two: ``draw_linear_gaussian_inputs`` draws the
ground truth, the measurement and the initial noise from a
``torch.Generator``, and ``sample_linear_gaussian_posterior_from`` runs
the port's ``FreeHunch``, ``prepare_schedule`` and ``sample_loop`` on
explicit inputs; ``sample_linear_gaussian_posterior`` is both, with the
JAX function's outputs and ``sample_loop``'s diagnostics. The exact
posterior is host float64 numpy.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from free_hunch_tpu_torch import randn, resolve_device, use_full_f32
from free_hunch_tpu_torch.guidance.mechanisms import FreeHunch
from free_hunch_tpu_torch.operators import get_operator
from free_hunch_tpu_torch.ops.dct import dct_2d, idct_2d
from free_hunch_tpu_torch.samplers.edm import prepare_schedule, sample_loop


def dct_gaussian_denoiser(v: torch.Tensor):
    """The exact denoiser of the prior N(0, IDCT diag(v) DCT); ``v`` is the
    (C, H, W) per-coefficient variance. Returns ``denoise(x, sigma) ->
    (mean, var)``, the framework's contract; ``var`` is the mean of the
    DCT-diagonal spectrum per pixel (mechanisms that read it use its scale)."""
    def denoise(x, sigma):
        s2 = torch.as_tensor(sigma, dtype=x.dtype, device=x.device) ** 2
        gain = v / (v + s2)
        mean = idct_2d(gain * dct_2d(x))
        var = torch.mean(s2 * gain).expand(x.shape)
        return mean, var

    return denoise


def make_smooth_spectrum(img_shape: Tuple[int, int, int], *, decades: float = 4.0,
                         v_max: float = 30.0) -> np.ndarray:
    """A radially decaying DCT variance spectrum spanning ``decades``
    orders of magnitude, shaped like the bundled ImageNet prior."""
    c, h, w = img_shape
    ky = np.arange(h)[:, None] / h
    kx = np.arange(w)[None, :] / w
    r = np.sqrt(ky**2 + kx**2) / np.sqrt(2.0)
    v = v_max * 10.0 ** (-decades * r)
    return np.broadcast_to(v, (c, h, w)).copy()


def dense_operator_matrix(op, img_shape: Tuple[int, int, int]) -> np.ndarray:
    """A (m, d): the identity basis pushed through ``op.forward``
    (noiseless) on the operator's device in f32, returned as host f64."""
    use_full_f32()
    d = int(np.prod(img_shape))
    eye = torch.eye(d, dtype=torch.float32, device=op.device).reshape((d,) + tuple(img_shape))
    with torch.no_grad():
        cols = op.forward(eye, noiseless=True)
    return cols.double().cpu().numpy().reshape(d, -1).T


def idct_basis_matrix(img_shape: Tuple[int, int, int], device=None) -> np.ndarray:
    """B (d, d), pixel = B @ dct_coeffs per channel block: the inverse DCT
    of the identity basis in f32 on ``device`` (default CUDA), as host f64."""
    use_full_f32()
    d = int(np.prod(img_shape))
    eye = torch.eye(d, dtype=torch.float32, device=resolve_device(device))
    return idct_2d(eye.reshape((d,) + tuple(img_shape))).double().cpu().numpy().reshape(d, -1).T


def exact_posterior(A: np.ndarray, B: np.ndarray, v: np.ndarray, y_flat: np.ndarray,
                    sigma_y: float) -> Tuple[np.ndarray, np.ndarray]:
    """The Gaussian posterior (mu, Sigma) of y = A x + sigma_y n with
    x ~ N(0, B diag(v) B^T), in float64."""
    prior_inv = (B / v.reshape(1, -1)) @ B.T
    H = A.T @ A / sigma_y**2 + prior_inv
    Sigma = np.linalg.inv(H)
    mu = Sigma @ (A.T @ y_flat) / sigma_y**2
    return mu, Sigma


def linear_gaussian_operator(img_shape: Tuple[int, int, int], operator_kwargs: dict,
                             sigma_y: float, device=None):
    """The measurement operator of one image of ``img_shape``."""
    return get_operator(in_shape=(1,) + tuple(img_shape), sigma_s=sigma_y,
                        device=resolve_device(device), **operator_kwargs)


def draw_linear_gaussian_inputs(v: np.ndarray, op, n: int,
                                generator: Optional[torch.Generator] = None):
    """From ``generator`` (default: a CPU generator seeded 0), in this
    order: the ground truth x_true = IDCT(sqrt(v) eps), its measurement
    y = A x_true + sigma_y n (one image) and the initial noise (n, C, H, W).
    Returns (noise, y, x_true) on the operator's device."""
    use_full_f32()
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = op.device
    shape = tuple(np.shape(v))
    eps = randn((1,) + shape, gen, device=dev)
    x_true = idct_2d(torch.sqrt(torch.as_tensor(v, dtype=torch.float32, device=dev)) * eps)
    with torch.no_grad():
        y = op.forward(x_true, generator=gen)
    noise = randn((n,) + shape, gen, device=dev)
    return noise, y, x_true


def sample_linear_gaussian_posterior_from(
        v: np.ndarray, noise: torch.Tensor, y: torch.Tensor, op, *, data_dir: str,
        num_steps: int = 40, sigma_max: float = 80.0,
        mechanism_kwargs: Optional[dict] = None):
    """Run the production pipeline (``FreeHunch`` with the DCT-diagonal
    prior, ``prepare_schedule``, ``sample_loop``) from ``noise``
    (n, C, H, W) with the measurement ``y`` (one image) broadcast over the
    batch in its own shape. ``data_dir`` receives ``dct_variance.npz``, so
    the mechanism loads the prior as the driver does. Returns (x, diag):
    the samples (n, C, H, W) and ``sample_loop``'s diagnostics (CG
    iterations per stage and the rest)."""
    np.savez(os.path.join(data_dir, "dct_variance.npz"), dct_variance=v.astype(np.float32))
    d = int(np.prod(np.shape(v)))
    vt = torch.as_tensor(v, dtype=torch.float32, device=noise.device)
    mkw = dict(cond_scaling=1.0, clip_x0_mean=False, image_base_covariance="dct_diagonal",
               data_dir=data_dir, init_denoiser_variance=1.0,
               init_noise_variance=sigma_max**2, data_dim=d, cov_capacity=16,
               max_rtol=1e-5, cg_maxiter=200, solver_type="customcuda")
    mkw.update(mechanism_kwargs or {})
    mech = FreeHunch(forward_operator=op, **mkw)
    xs, sigma0_scaled = prepare_schedule(
        round_sigma=lambda s, return_index=False: s, net_sigma_min=2e-3,
        net_sigma_max=sigma_max, num_steps=num_steps, solver="heun", discretization="edm",
        schedule="linear", scaling="none", sigma_min=2e-3, sigma_max=sigma_max)
    y_b = y.expand((noise.shape[0],) + tuple(y.shape[1:])).contiguous()
    x, _, diag = sample_loop(dct_gaussian_denoiser(vt), mech, noise, y_b, xs,
                             sigma0_scaled=sigma0_scaled, collect_diagnostics=True)
    return x, diag


def sample_linear_gaussian_posterior(
        v: np.ndarray, *, img_shape: Tuple[int, int, int], operator_kwargs: dict,
        sigma_y: float, data_dir: str, n: int = 128, num_steps: int = 40,
        sigma_max: float = 80.0, generator: Optional[torch.Generator] = None,
        mechanism_kwargs: Optional[dict] = None, device=None):
    """Draw the problem from ``generator`` and sample its posterior on
    ``device`` (default CUDA). Returns ``(samples (n, d), y (m,), op,
    x_true (d,), diag)``: the JAX function's four, the arrays as host
    numpy, and ``sample_loop``'s diagnostics."""
    op = linear_gaussian_operator(img_shape, operator_kwargs, sigma_y, device)
    noise, y, x_true = draw_linear_gaussian_inputs(v, op, n, generator)
    x, diag = sample_linear_gaussian_posterior_from(
        v, noise, y, op, data_dir=data_dir, num_steps=num_steps, sigma_max=sigma_max,
        mechanism_kwargs=mechanism_kwargs)
    return (x.reshape(n, -1).cpu().numpy(), y.reshape(-1).cpu().numpy(), op,
            x_true.reshape(-1).cpu().numpy(), diag)
