"""FFT-diagonalised convolution helpers for the measurement operators and the
guidance solvers.

Counterpart of ``free_hunch_tpu/ops/fftops.py``: ``fft2``/``ifft2``,
``rfft2``/``irfft2``, ``fftn2``/``ifftn2`` (:45-62), ``p2o_np`` (:64),
``p2o`` (:83-103), ``upsample``, ``downsample``, ``splits`` (:105-131),
``pre_calculate`` (:134-146), ``fft_conv`` (:149), the centred
``fft2c``/``ifft2c`` (:154-166) and ``data_solution`` (:169-181), the
closed-form data step of half-quadratic splitting. The FFTs are
``torch.fft`` (cuFFT on the card). Arrays are NCHW; complex arrays are
complex64, complex128 for float64 inputs.
"""
from __future__ import annotations

import numpy as np
import torch


def fft2(x: torch.Tensor, norm=None) -> torch.Tensor:
    """2-D FFT over the last two axes."""
    return torch.fft.fft2(x, norm=norm)


def ifft2(x: torch.Tensor, norm=None) -> torch.Tensor:
    """Inverse 2-D FFT over the last two axes."""
    return torch.fft.ifft2(x, norm=norm)


def rfft2(x: torch.Tensor) -> torch.Tensor:
    """Real-input 2-D FFT over the last two axes (W // 2 + 1 columns)."""
    return torch.fft.rfft2(x)


def irfft2(x: torch.Tensor, s) -> torch.Tensor:
    """Inverse of ``rfft2`` onto the real (H, W) grid ``s``."""
    return torch.fft.irfft2(x, s=s)


def fftn2(x: torch.Tensor, norm=None) -> torch.Tensor:
    """N-D FFT over the last two axes (``jnp.fft.fftn(x, axes=(-2, -1))``)."""
    return torch.fft.fftn(x, dim=(-2, -1), norm=norm)


def ifftn2(x: torch.Tensor, norm=None) -> torch.Tensor:
    """Inverse of ``fftn2``."""
    return torch.fft.ifftn(x, dim=(-2, -1), norm=norm)


def _complex(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of a real (or complex) one."""
    return torch.complex128 if dtype in (torch.float64, torch.complex128) else torch.complex64


def p2o_np(psf, shape) -> np.ndarray:
    """Point-spread function -> optical transfer function, on the host.

    Zero-pads the (..., h, w) PSF to ``shape`` (centre-cropping PSFs larger
    than the grid), rolls its centre to the origin and FFTs; complex64."""
    psf = np.asarray(psf)
    h, w = psf.shape[-2], psf.shape[-1]
    H, W = shape
    if h > H or w > W:
        ch, cw = min(h, H), min(w, W)
        psf = psf[..., (h - ch) // 2:(h - ch) // 2 + ch,
                  (w - cw) // 2:(w - cw) // 2 + cw]
        h, w = ch, cw
    otf = np.zeros(psf.shape[:-2] + tuple(shape), np.complex64)
    otf[..., :h, :w] = psf
    otf = np.roll(otf, (-(h // 2), -(w // 2)), axis=(-2, -1))
    return np.fft.fftn(otf, axes=(-2, -1)).astype(np.complex64)


def p2o(psf: torch.Tensor, shape) -> torch.Tensor:
    """``p2o_np`` on a tensor, on its device: zero-pad the (..., h, w) PSF
    to ``shape`` (centre-cropping PSFs larger than the grid), roll its
    centre to the origin and FFT."""
    h, w = psf.shape[-2], psf.shape[-1]
    H, W = shape
    if h > H or w > W:
        ch, cw = min(h, H), min(w, W)
        psf = psf[..., (h - ch) // 2:(h - ch) // 2 + ch, (w - cw) // 2:(w - cw) // 2 + cw]
        h, w = ch, cw
    otf = psf.new_zeros(psf.shape[:-2] + tuple(shape))
    otf[..., :h, :w] = psf
    otf = torch.roll(otf, (-(h // 2), -(w // 2)), dims=(-2, -1))
    return fftn2(otf)


def upsample(x: torch.Tensor, sf: int = 3) -> torch.Tensor:
    """s-fold zero-filling upsampler (adjoint of ``downsample``)."""
    if sf == 1:
        return x
    z = x.new_zeros(x.shape[:-2] + (x.shape[-2] * sf, x.shape[-1] * sf))
    z[..., ::sf, ::sf] = x
    return z


def downsample(x: torch.Tensor, sf: int = 3) -> torch.Tensor:
    """s-fold stride sampler keeping the upper-left pixel of each sf x sf patch."""
    if sf == 1:
        return x
    return x[..., ::sf, ::sf]


def splits(a: torch.Tensor, sf: int) -> torch.Tensor:
    """Split (..., W, H) into sf*sf distinct blocks stacked on a new last
    axis: (..., W/sf, H/sf, sf^2), chunked on rows first, then columns."""
    *lead, w, h = a.shape
    b = a.reshape(*lead, sf, w // sf, h)
    b = torch.movedim(b, -3, -1)  # (..., W/sf, H, sf)
    b = b.reshape(*lead, w // sf, sf, h // sf, b.shape[-1])
    b = torch.movedim(b, -3, -1)  # (..., W/sf, H/sf, sf, sf)
    return b.reshape(*lead, w // sf, h // sf, sf * sf)


def pre_calculate(x: torch.Tensor, k: torch.Tensor, sf: int):
    """The FFT tuple (FB, FBC, F2B, FBFy) that the data step reuses: x is
    the (N, C, H, W) low-resolution measurement, k the (N, C, h, w) kernel."""
    w, h = x.shape[-2], x.shape[-1]
    cdt = _complex(x.dtype)
    FB = p2o(k.to(cdt), (w * sf, h * sf))
    FBC = torch.conj(FB).resolve_conj()
    F2B = torch.abs(FB) ** 2
    FBFy = FBC * fftn2(upsample(x, sf=sf).to(cdt))
    return FB, FBC, F2B, FBFy


def fft_conv(x: torch.Tensor, FB: torch.Tensor) -> torch.Tensor:
    """Circular convolution via the precomputed OTF: real(ifft2(FB * fft2(x)))."""
    cdt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    return ifft2(FB * fft2(x.to(cdt))).real.to(x.dtype)


def fft2c(x: torch.Tensor) -> torch.Tensor:
    """Centred orthonormal 2-D FFT (phase retrieval's)."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    return torch.fft.fftshift(fft2(x, norm="ortho"), dim=(-2, -1))


def ifft2c(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fft2c``."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    return torch.fft.fftshift(ifft2(x, norm="ortho"), dim=(-2, -1))


def data_solution(x: torch.Tensor, FB, FBC, F2B, FBFy, alpha, sf: int) -> torch.Tensor:
    """Closed-form data-term proximal step of half-quadratic splitting for
    super-resolution and deblurring (DiffPIR-style solvers); ``alpha`` is a
    number or a tensor broadcast over (N, C, H, W), clipped at 1e-2."""
    cdt = _complex(x.dtype)
    alpha = torch.clamp(torch.as_tensor(alpha, dtype=torch.float32, device=x.device), min=1e-2)
    FR = FBFy + fftn2((alpha * x).to(cdt))
    FBR = torch.mean(splits(FB * FR, sf), dim=-1)
    invW = torch.mean(splits(F2B, sf), dim=-1)
    invWBR = FBR / (invW + alpha)
    FCBinvWBR = FBC * invWBR.repeat(1, 1, sf, sf)
    FX = (FR - FCBinvWBR) / alpha.to(cdt)
    return ifftn2(FX).real.to(x.dtype)
