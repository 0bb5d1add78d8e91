"""Guidance linear-system ("mat") solver for the deblur family:
u = (A C A^T + sigma_s^2 I)^-1 (y - A x0_mean), mat = A^T u.

Counterpart of the pixel-space CG path of
``free_hunch_tpu/guidance/solvers.py``: ``rtol_schedule`` (:36-49),
``_run_cg`` (:72-107), ``_dct_spec_to_fourier`` (:117), ``_mean_variance``
(:134), ``deblur_mat_cg`` (:173-220) and ``choose_solver`` (:472-569) for
``gaussian_blur``/``motion_blur`` with the ``cg``/``customcuda`` method.
The closed-form and scipy-budget methods, the other operator families and
the Fourier-coordinate solver (``deblur_mat_cg_fourier``) are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from free_hunch_tpu_torch.ops import cg as cg_mod
from free_hunch_tpu_torch.ops.fftops import fft2, ifft2

# f32 CG reaches ~1e-6..1e-7 relative residual; tighter requests are noise.
RTOL_F32_FLOOR = 1e-6


def rtol_schedule(sigma, rtol_max=1.0, rtol_min=1e-14, p=0.1,
                  floor=RTOL_F32_FLOOR) -> float:
    """Log-log interpolated CG tolerance, tight at small sigma, clamped at
    the f32-achievable floor. Host f32 arithmetic, as the JAX version's."""
    f = np.float32
    sigma_min, sigma_max = f(0.1), f(80.0)
    s = np.clip(f(sigma), sigma_min, sigma_max)
    ratio = ((np.log10(s) - np.log10(sigma_min))
             / (np.log10(sigma_max) - np.log10(sigma_min)))
    log_factor = np.clip(ratio, f(0.0), f(1.0)) ** f(p)
    log_rtol = (log_factor * (np.log10(f(rtol_max)) - np.log10(f(rtol_min)))
                + np.log10(f(rtol_min)))
    return float(np.maximum(f(10.0) ** log_rtol, f(floor)))


def _cdt(x):
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def _fft2(x):
    return fft2(x.to(_cdt(x)))


def _ifft2_r(x):
    r = ifft2(x).real
    return r.to(torch.float64 if r.dtype == torch.float64 else torch.float32)


def _flatten(v):
    return v.reshape(v.shape[0], -1)


def _run_cg(matvec_img: Callable, b_img: torch.Tensor, rtol, maxiter: int,
            precond: Optional[Callable] = None, warm_start: bool = False,
            min_iter: int = 0, stall_iters: int = 25, track_best: bool = True,
            x0_init: Optional[torch.Tensor] = None, x0_init_valid: Optional[bool] = None):
    """CG over (B, ...) image-shaped systems via flatten/unflatten.

    warm_start starts from x0 = b (the reference torch CG's default);
    x0_init overrides the start (solution recycling across guidance stages)
    unless ``x0_init_valid`` is False, e.g. on a run's first stage."""
    shape = b_img.shape

    def mv(v):
        return _flatten(matvec_img(v.reshape(shape)))

    x0 = _flatten(b_img) if warm_start else None
    if x0_init is not None and x0_init_valid is not False:
        x0 = _flatten(x0_init)
    pc = None if precond is None else (lambda v: _flatten(precond(v.reshape(shape))))
    u, info = cg_mod.cg_batch(mv, _flatten(b_img), rtol=rtol, maxiter=maxiter,
                              precond=pc, x0=x0, min_iter=min_iter,
                              stall_iters=stall_iters, track_best=track_best)
    return u.reshape(shape), info


def _apply_c(v, theta0_var=None, cov_mv: Optional[Callable] = None):
    """C @ v: scalar/diagonal variance or low-rank covariance-model matvec."""
    if cov_mv is not None:
        return cov_mv(v)
    return theta0_var * v


def _dct_spec_to_fourier(spec: torch.Tensor) -> torch.Tensor:
    """Per-DCT-coefficient variances (B, C, H, W) -> approximate DFT power
    spectrum on the same grid (DCT index ~ 2x the folded DFT index)."""
    H, W = spec.shape[-2], spec.shape[-1]

    def idx(n):
        i = torch.arange(n, device=spec.device)
        f = torch.minimum(i, n - i)
        return torch.clamp(2 * f, max=n - 1)

    return spec[..., idx(H), :][..., :, idx(W)]


def _mean_variance(theta0_var, cov_trace_mean, x_like):
    """Per-sample scalar proxy v_bar of C for preconditioning, floored at
    1e-8 to keep the preconditioner SPD. Returns (B,) or None."""
    b = x_like.shape[0]
    if cov_trace_mean is not None:
        v = torch.as_tensor(cov_trace_mean, dtype=x_like.dtype,
                            device=x_like.device).broadcast_to((b,))
        return torch.clamp(v, min=1e-8)
    if theta0_var is None:
        return None
    t = torch.as_tensor(theta0_var, dtype=x_like.dtype, device=x_like.device)
    v = t.broadcast_to((b,)) if t.dim() == 0 else t.reshape(b, -1).mean(dim=-1)
    return torch.clamp(v, min=1e-8)


def deblur_mat_cg(operator, y, x0_mean, *, theta0_var=None, cov_mv=None,
                  rtol=1e-4, maxiter=1000, cov_trace_mean=None,
                  return_info=False, warm_start=False, min_iter=0,
                  precondition=True, stall_iters=25, cov_fourier_spec=None,
                  track_best=True, u_init=None, u_init_valid=None,
                  return_u=False):
    """General-covariance deblur solve in pixel space. Per CG iteration:
    u -> sigma_s^2 u + A C A^T u with A^T via FBC. Preconditioned with the
    Fourier-diagonal inverse for a spectral (or scalar) model of C."""
    sigma_s = float(max(np.float32(operator.sigma_s), np.float32(0.001)))
    FB, FBC, F2B, _ = operator.pre_calculated

    def matvec(u):
        v = _ifft2_r(FBC * _fft2(u))          # A^T u
        v = _apply_c(v, theta0_var, cov_mv)   # C .
        v = _ifft2_r(FB * _fft2(v))           # A .
        return sigma_s**2 * u + v

    precond = None
    if precondition and cov_fourier_spec is not None:
        denom = sigma_s**2 + torch.clamp(cov_fourier_spec, min=1e-8) * F2B
        precond = lambda r: _ifft2_r(_fft2(r) / denom)  # noqa: E731
    elif precondition:
        vbar = _mean_variance(theta0_var, cov_trace_mean, x0_mean)
        if vbar is not None:
            denom = sigma_s**2 + vbar[:, None, None, None] * F2B
            precond = lambda r: _ifft2_r(_fft2(r) / denom)  # noqa: E731

    b = y - _ifft2_r(FB * _fft2(x0_mean))
    u, info = _run_cg(matvec, b, rtol, maxiter, precond=precond,
                      warm_start=warm_start, min_iter=min_iter,
                      stall_iters=stall_iters, track_best=track_best,
                      x0_init=u_init, x0_init_valid=u_init_valid)
    mat = _ifft2_r(FBC * _fft2(u))
    if return_u:
        return mat, info, u
    return (mat, info) if return_info else mat


_CG = {"gaussian_blur": deblur_mat_cg, "motion_blur": deblur_mat_cg}


def choose_solver(operator, y, x0_mean, *, theta0_var=None, cov_mv=None,
                  method: str = "cg", max_rtol: float = 1.0, sigma_t=None,
                  use_rtol_func: bool = False, maxiter: Optional[int] = None,
                  cov_trace_mean=None, return_info: bool = False,
                  precondition: bool = True, stall_iters: int = 25,
                  cov_dct_diag=None, rtol_floor: float = RTOL_F32_FLOOR,
                  track_best: bool = True, cg_coords: str = "pixel",
                  u_init=None, u_init_valid=None, return_u: bool = False):
    """Solve for ``mat`` given an operator by name (the JAX ``choose_solver``
    for the deblur family and the ``cg``/``customcuda`` method): on-device CG
    with the tight rtol schedule (maxiter 5000), warm-started from x0 = b
    with one forced update, or from ``u_init`` when recycling.

    cg_coords: 'pixel' (default) or 'auto', which means 'pixel' here until
    the card has measured the Fourier-coordinate solver, which is not ported
    yet ('fourier' raises)."""
    name = operator.name
    if name not in _CG:
        raise NotImplementedError(f"no mat solver for operator {name!r} in the "
                                  f"port yet; have {sorted(_CG)}")
    if return_u and not return_info:
        raise ValueError("return_u=True requires return_info=True")
    if method in ("closed_form", "scipy", "customscipy"):
        raise NotImplementedError(f"solver method {method!r} is not ported yet "
                                  "(only 'cg' / 'customcuda')")
    if method not in ("cg", "customcuda"):
        raise ValueError(f"unknown solver method {method!r}; expected "
                         "closed_form | scipy | cg | customcuda | customscipy")
    if cg_coords == "fourier":
        raise NotImplementedError("cg_coords='fourier' (deblur_mat_cg_fourier) "
                                  "is not ported yet; use 'pixel'")
    if cg_coords not in ("auto", "pixel"):
        raise ValueError(f"cg_coords must be 'auto', 'fourier' or 'pixel', "
                         f"got {cg_coords!r}")
    spec = None
    if cov_dct_diag is not None:
        spec = _dct_spec_to_fourier(cov_dct_diag.reshape(x0_mean.shape))
    rtol = (rtol_schedule(sigma_t, max_rtol, floor=rtol_floor)
            if sigma_t is not None else 1e-4)
    return _CG[name](operator, y, x0_mean, theta0_var=theta0_var, cov_mv=cov_mv,
                     rtol=rtol, maxiter=maxiter or 5000,
                     cov_trace_mean=cov_trace_mean, return_info=return_info,
                     warm_start=True, min_iter=1, precondition=precondition,
                     stall_iters=stall_iters, cov_fourier_spec=spec,
                     track_best=track_best, u_init=u_init,
                     u_init_valid=u_init_valid, return_u=return_u)
