"""Guidance linear-system ("mat") solvers: u = (A C A^T + sigma_s^2 I)^-1 r,
mat = A^T u, with r = y - A x0_mean.

Counterpart of ``free_hunch_tpu/guidance/solvers.py``, all of it: the rtol
schedules (:36-55), ``_run_cg`` (:72), the closed forms and the CG solvers
of the deblur family (pixel and weighted-rfft2 coordinates), of
super-resolution and of inpainting (:162-460), and ``choose_solver``
(:472-569) with every method and ``cg_coords``. C is a scalar or per-pixel
variance, or the Free Hunch covariance matvec. Host scalars (sigma_s, rtol,
the variance of the scalar families) are Python numbers computed in f32
arithmetic, as the JAX package computes them.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from free_hunch_tpu_torch.ops import cg as cg_mod
from free_hunch_tpu_torch.ops.fftops import (downsample, fft2, ifft2, irfft2, rfft2, splits,
                                             upsample)

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


def rtol_schedule_2(sigma, rtol_max=1.0, rtol_min=1e-4, p=0.05) -> float:
    """The looser schedule of the scipy-budget paths (TMPD)."""
    return rtol_schedule(sigma, rtol_max, rtol_min, p)


def _clip_sigma_s(operator, lo: float) -> float:
    return float(max(np.float32(operator.sigma_s), np.float32(lo)))


def _ndim(t) -> int:
    return t.dim() if torch.is_tensor(t) else int(np.ndim(t))


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


# ---------------------------------------------------------------------------
# Deblur (gaussian_blur / motion_blur): A = ifft2(FB * fft2(.)) circular conv.
# ---------------------------------------------------------------------------

def deblur_mat_closed_form(operator, y, x0_mean, theta0_var, return_u=False):
    """Scalar variance: the system is diagonal in Fourier space."""
    sigma_s = _clip_sigma_s(operator, 0.001)
    FB, FBC, F2B, _ = operator.pre_calculated
    resid = y - _ifft2_r(FB * _fft2(x0_mean))
    uf = _fft2(resid) / (sigma_s**2 + theta0_var * F2B)
    mat = _ifft2_r(uf * FBC)
    return (mat, _ifft2_r(uf)) if return_u else mat


def deblur_mat_cg(operator, y, x0_mean, *, theta0_var=None, cov_mv=None,
                  rtol=1e-4, maxiter=1000, cov_trace_mean=None,
                  return_info=False, warm_start=False, min_iter=0,
                  precondition=True, stall_iters=25, cov_fourier_spec=None,
                  track_best=True, u_init=None, u_init_valid=None,
                  return_u=False):
    """General-covariance deblur solve in pixel space. Per CG iteration:
    u -> sigma_s^2 u + A C A^T u with A^T via FBC. Preconditioned with the
    Fourier-diagonal inverse for a spectral (or scalar) model of C."""
    sigma_s = _clip_sigma_s(operator, 0.001)
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


def _rfft_col_weights(W: int, dtype, device=None) -> torch.Tensor:
    """Multiplicity of each retained rfft2 column in the full spectrum:
    2 for 0 < k2 < W/2 (the conjugate column is dropped), 1 for the
    self-conjugate columns k2 = 0 and (even W) k2 = W/2."""
    Wh = W // 2 + 1
    w = torch.full((Wh,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    if W % 2 == 0:
        w[Wh - 1] = 1.0
    return w


def deblur_mat_cg_fourier(operator, y, x0_mean, *, theta0_var=None, cov_mv=None,
                          rtol=1e-4, maxiter=1000, cov_trace_mean=None,
                          return_info=False, warm_start=False, min_iter=0,
                          precondition=True, stall_iters=25,
                          cov_fourier_spec=None, track_best=True,
                          u_init=None, u_init_valid=None, return_u=False):
    """``deblur_mat_cg`` in weighted rfft2 coordinates: CG runs on
    w = rfft2(u), real and imaginary parts stacked, each retained column
    scaled by the square root of its spectral multiplicity. Every inner
    product is then H*W times its pixel-space value (Parseval), so the
    alphas, betas, relative residuals and stopping decisions are the pixel
    solver's in exact arithmetic; a matvec costs one irfft2+rfft2 pair and
    the preconditioner is an elementwise divide. ``u_init`` and the
    returned u are in pixel space, shared with the pixel solver; residual
    norms are reported on the pixel scale."""
    sigma_s = _clip_sigma_s(operator, 0.001)
    FB, FBC, F2B, _ = operator.pre_calculated
    B_, C_, H, W = x0_mean.shape
    Wh = W // 2 + 1
    rdt = x0_mean.dtype
    FBh = FB[..., :Wh]
    FBCh = FBC[..., :Wh]
    F2Bh = F2B[..., :Wh].to(rdt)
    sqw = torch.sqrt(_rfft_col_weights(W, rdt, x0_mean.device))[:, None]  # (Wh, 1)
    cshape = (B_, C_, H, Wh)

    def pack(c):  # complex (B, C, H, Wh) -> real (B, n)
        z = torch.stack([c.real.to(rdt), c.imag.to(rdt)], dim=-1) * sqw
        return z.reshape(z.shape[0], -1)

    def unpack(x):  # real (B, n) -> complex (B, C, H, Wh)
        z = x.reshape(cshape + (2,)) / sqw
        return torch.complex(z[..., 0], z[..., 1])

    def matvec(xf):
        v = irfft2(FBCh * unpack(xf), s=(H, W)).to(rdt)  # A^T u (pixel)
        v = _apply_c(v, theta0_var, cov_mv)               # C .
        return sigma_s**2 * xf + pack(FBh * rfft2(v))     # F(A .)

    precond = None
    if precondition:
        denom = None
        if cov_fourier_spec is not None:
            denom = sigma_s**2 + torch.clamp(cov_fourier_spec[..., :Wh], min=1e-8) * F2Bh
        else:
            vbar = _mean_variance(theta0_var, cov_trace_mean, x0_mean)
            if vbar is not None:
                denom = sigma_s**2 + vbar[:, None, None, None] * F2Bh
        if denom is not None:
            # diagonal in these coordinates; the sqrt-weight scaling commutes
            def precond(xf):
                z = xf.reshape((xf.shape[0],) + cshape[1:] + (2,)) / denom[..., None]
                return z.reshape(xf.shape)

    b_pix = y - irfft2(FBh * rfft2(x0_mean), s=(H, W)).to(rdt)
    b_f = pack(rfft2(b_pix))
    x0_f = b_f if warm_start else None
    if u_init is not None and u_init_valid is not False:
        x0_f = pack(rfft2(u_init.to(rdt)))
    u_f, info = cg_mod.cg_batch(matvec, b_f, rtol=rtol, maxiter=maxiter,
                                precond=precond, x0=x0_f, min_iter=min_iter,
                                stall_iters=stall_iters, track_best=track_best)
    # || . ||_packed = sqrt(H*W) x the pixel norm
    info = info._replace(residual_norm=info.residual_norm / float(np.sqrt(H * W)))
    mat = irfft2(FBCh * unpack(u_f), s=(H, W)).to(rdt)
    if return_u:
        return mat, info, irfft2(unpack(u_f), s=(H, W)).to(rdt)
    return (mat, info) if return_info else mat


# ---------------------------------------------------------------------------
# Super-resolution: A = downsample(ifft2(FB * fft2(.)), sf), the FFT surrogate.
# ---------------------------------------------------------------------------

def _sr_inv_w(F2B, sf: int):
    """Per low-resolution bin, the mean of |FB|^2 over its sf^2 aliases."""
    return torch.mean(splits(F2B, sf), dim=-1)


def _sr_low_idx(n_full: int, sf: int, device=None) -> torch.Tensor:
    """The full grid's spectrum indices that the low-resolution grid's DFT
    bins stand for: bin j is the folded frequency min(j, n_s - j) * sf. An
    ascending corner slice (0 .. n_s - 1) has the right shape and gives the
    wrong preconditioner; only the CG count shows it."""
    n_s = n_full // sf
    j = torch.arange(n_s, device=device)
    return torch.clamp(torch.minimum(j, n_s - j) * sf, max=n_full - 1)


def sr_mat_closed_form(operator, y, x0_mean, theta0_var, return_u=False):
    """Scalar variance via the polyphase (splits) identity."""
    sigma_s = _clip_sigma_s(operator, 0.01)
    sf = operator.scale_factor
    FB, FBC, F2B, _ = operator.pre_calculated
    resid = y - downsample(_ifft2_r(FB * _fft2(x0_mean)), sf)
    num = _fft2(resid) / (sigma_s**2 + theta0_var * _sr_inv_w(F2B, sf))
    mat = _ifft2_r(FBC * num.repeat(1, 1, sf, sf))
    return (mat, _ifft2_r(num)) if return_u else mat


def sr_mat_cg(operator, y, x0_mean, *, theta0_var=None, cov_mv=None,
              rtol=1e-4, maxiter=1000, cov_trace_mean=None,
              return_info=False, warm_start=False, min_iter=0,
              precondition=True, stall_iters=25, cov_fourier_spec=None,
              track_best=True, u_init=None, u_init_valid=None,
              return_u=False):
    """General-covariance SR solve on the low-resolution grid, with the
    polyphase-diagonal preconditioner for a spectral (or scalar) model of C."""
    sigma_s = _clip_sigma_s(operator, 0.01)
    sf = operator.scale_factor
    FB, FBC, F2B, _ = operator.pre_calculated

    def matvec(u):
        v = _ifft2_r(FBC * _fft2(upsample(u, sf)))
        v = _apply_c(v, theta0_var, cov_mv)
        v = downsample(_ifft2_r(FB * _fft2(v)), sf)
        return sigma_s**2 * u + v

    precond = None
    if precondition and cov_fourier_spec is not None:
        n_h, n_w = cov_fourier_spec.shape[-2:]
        dev = cov_fourier_spec.device
        low = cov_fourier_spec[..., _sr_low_idx(n_h, sf, dev), :]
        low = low[..., :, _sr_low_idx(n_w, sf, dev)]
        denom = sigma_s**2 + torch.clamp(low, min=1e-8) * _sr_inv_w(F2B, sf)
        precond = lambda r: _ifft2_r(_fft2(r) / denom)  # noqa: E731
    elif precondition:
        vbar = _mean_variance(theta0_var, cov_trace_mean, x0_mean)
        if vbar is not None:
            denom = sigma_s**2 + vbar[:, None, None, None] * _sr_inv_w(F2B, sf)
            precond = lambda r: _ifft2_r(_fft2(r) / denom)  # noqa: E731

    b = y - downsample(_ifft2_r(FB * _fft2(x0_mean)), sf)
    u, info = _run_cg(matvec, b, rtol, maxiter, precond=precond,
                      warm_start=warm_start, min_iter=min_iter,
                      stall_iters=stall_iters, track_best=track_best,
                      x0_init=u_init, x0_init_valid=u_init_valid)
    mat = _ifft2_r(FBC * _fft2(upsample(u, sf)))
    if return_u:
        return mat, info, u
    return (mat, info) if return_info else mat


# ---------------------------------------------------------------------------
# Inpainting: A = mask * .
# ---------------------------------------------------------------------------

def inpainting_mat_closed_form(operator, y, x0_mean, theta0_var, return_u=False):
    """Scalar variance: the system is diagonal in pixel space."""
    sigma_s = _clip_sigma_s(operator, 0.001)
    mask = operator.mask
    mat = (mask * y - mask * x0_mean) / (sigma_s**2 + theta0_var)
    # mat = A^T u = mask * u equals u itself (u carries the mask factor)
    return (mat, mat) if return_u else mat


def inpainting_mat_cg(operator, y, x0_mean, *, theta0_var=None, cov_mv=None,
                      rtol=1e-4, maxiter=1000, cov_trace_mean=None,
                      return_info=False, warm_start=False, min_iter=0,
                      precondition=True, stall_iters=25, cov_fourier_spec=None,
                      track_best=True, u_init=None, u_init_valid=None,
                      return_u=False):
    """General-covariance inpainting solve, Jacobi-preconditioned: exactly
    for a per-pixel variance, with v_bar for a scalar model of C.
    ``cov_fourier_spec`` is not used (a mask is not diagonal in Fourier
    space)."""
    sigma_s = _clip_sigma_s(operator, 0.001)
    mask = operator.mask

    def matvec(u):
        v = _apply_c(mask * u, theta0_var, cov_mv)
        return sigma_s**2 * u + mask * v

    precond = None
    if precondition:
        if theta0_var is not None and _ndim(theta0_var) > 0:
            tv = torch.clamp(torch.as_tensor(theta0_var, dtype=x0_mean.dtype,
                                             device=x0_mean.device), min=1e-8)
            denom = sigma_s**2 + tv * mask
            precond = lambda r: r / denom  # noqa: E731
        else:
            vbar = _mean_variance(theta0_var, cov_trace_mean, x0_mean)
            if vbar is not None:
                denom = sigma_s**2 + vbar[:, None, None, None] * mask
                precond = lambda r: r / denom  # noqa: E731

    b = mask * y - mask * x0_mean
    mat, info = _run_cg(matvec, b, rtol, maxiter, precond=precond,
                        warm_start=warm_start, min_iter=min_iter,
                        stall_iters=stall_iters, track_best=track_best,
                        x0_init=u_init, x0_init_valid=u_init_valid)
    if return_u:
        # mat = mask * u is applied inside the matvec: the iterate is u too
        return mat, info, mat
    return (mat, info) if return_info else mat


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_CLOSED = {"gaussian_blur": deblur_mat_closed_form, "motion_blur": deblur_mat_closed_form,
           "super_resolution": sr_mat_closed_form, "inpainting": inpainting_mat_closed_form}
_CG = {"gaussian_blur": deblur_mat_cg, "motion_blur": deblur_mat_cg,
       "super_resolution": sr_mat_cg, "inpainting": inpainting_mat_cg}


def _no_cg_info(x0_mean):
    """CGInfo of a closed-form solve: zero iterations, converged, no sync."""
    b = x0_mean.shape[0]
    return cg_mod.CGInfo(niter=0, residual_norm=x0_mean.new_zeros((b,), dtype=torch.float32),
                         optimal=torch.ones((b,), dtype=torch.bool, device=x0_mean.device),
                         host_syncs=0)


def choose_solver(operator, y, x0_mean, *, theta0_var=None, cov_mv=None,
                  method: str = "cg", max_rtol: float = 1.0, sigma_t=None,
                  use_rtol_func: bool = False, maxiter: Optional[int] = None,
                  cov_trace_mean=None, return_info: bool = False,
                  precondition: bool = True, stall_iters: int = 25,
                  cov_dct_diag=None, rtol_floor: float = RTOL_F32_FLOOR,
                  track_best: bool = True, cg_coords: str = "auto",
                  u_init=None, u_init_valid=None, return_u: bool = False):
    """Solve for ``mat`` given an operator by name.

    method:
      'closed_form' / 'scipy' with a scalar variance and no ``cov_mv``: the
        Fourier/diagonal closed form (``CGInfo`` of zero iterations);
        otherwise the scipy-budget CG below.
      'cg' / 'customcuda': CG with the tight rtol schedule (maxiter 5000),
        warm-started from x0 = b with one forced update.
      'scipy' / 'customscipy' (and the closed-form fallbacks): CG from
        x0 = 0 at rtol 1e-4, or ``rtol_schedule_2`` with ``use_rtol_func``,
        maxiter 1000.

    return_u (needs return_info): also return the measurement-space
    solution u, which ``u_init`` takes back on the next stage
    (``u_init_valid`` False on the first).

    cg_coords: the deblur family's CG coordinates, 'pixel' or 'fourier'
    (``deblur_mat_cg_fourier``); 'auto' takes 'fourier' for a CPU tensor
    and 'pixel' for a CUDA one, as the JAX package decides by backend."""
    name = operator.name
    if name not in _CLOSED:
        raise ValueError(f"no mat solver for operator {name!r}; expected one of "
                         f"{sorted(_CLOSED)}")
    if return_u and not return_info:
        raise ValueError("return_u=True requires return_info=True")
    if method not in ("closed_form", "scipy", "cg", "customcuda", "customscipy"):
        raise ValueError(f"unknown solver method {method!r}; expected "
                         "closed_form | scipy | cg | customcuda | customscipy")
    if cg_coords == "auto":
        cg_coords = "fourier" if x0_mean.device.type == "cpu" else "pixel"
    cg_table = dict(_CG)
    if cg_coords == "fourier" and name in ("gaussian_blur", "motion_blur"):
        cg_table[name] = deblur_mat_cg_fourier
    elif cg_coords not in ("fourier", "pixel"):
        raise ValueError(f"cg_coords must be 'auto', 'fourier' or 'pixel', "
                         f"got {cg_coords!r}")
    spec = None
    if cov_dct_diag is not None:
        spec = _dct_spec_to_fourier(cov_dct_diag.reshape(x0_mean.shape))
    scalarish = cov_mv is None and theta0_var is not None and _ndim(theta0_var) == 0
    if method in ("closed_form", "scipy") and scalarish:
        if return_u:
            mat, u = _CLOSED[name](operator, y, x0_mean, theta0_var, return_u=True)
            return mat, _no_cg_info(x0_mean), u
        mat = _CLOSED[name](operator, y, x0_mean, theta0_var)
        return (mat, _no_cg_info(x0_mean)) if return_info else mat
    recycle = dict(u_init=u_init, u_init_valid=u_init_valid, return_u=return_u)
    if method in ("cg", "customcuda"):
        rtol = (rtol_schedule(sigma_t, max_rtol, floor=rtol_floor)
                if sigma_t is not None else 1e-4)
        return cg_table[name](operator, y, x0_mean, theta0_var=theta0_var, cov_mv=cov_mv,
                              rtol=rtol, maxiter=maxiter or 5000,
                              cov_trace_mean=cov_trace_mean, return_info=return_info,
                              warm_start=True, min_iter=1, precondition=precondition,
                              stall_iters=stall_iters, cov_fourier_spec=spec,
                              track_best=track_best, **recycle)
    rtol = rtol_schedule_2(sigma_t) if (sigma_t is not None and use_rtol_func) else 1e-4
    return cg_table[name](operator, y, x0_mean, theta0_var=theta0_var, cov_mv=cov_mv,
                          rtol=rtol, maxiter=maxiter or 1000,
                          cov_trace_mean=cov_trace_mean, return_info=return_info,
                          precondition=precondition, stall_iters=stall_iters,
                          cov_fourier_spec=spec, track_best=track_best, **recycle)
