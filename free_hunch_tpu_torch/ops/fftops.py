"""FFT-diagonalised convolution helpers for the measurement operators and the
guidance solvers.

Counterpart of ``free_hunch_tpu/ops/fftops.py``: ``fft2``/``ifft2``,
``rfft2``/``irfft2`` (:45-61), ``p2o_np`` (:64), ``upsample``,
``downsample``, ``splits`` (:105-131), ``fft_conv`` (:149) and the centred
``fft2c``/``ifft2c`` (:154-166). The FFTs are ``torch.fft`` (cuFFT on the
card). Arrays are NCHW.
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
