"""FFT-diagonalised circular convolution for the blur operators.

Counterpart of ``free_hunch_tpu/ops/fftops.py``: only ``fft2``/``ifft2``,
``p2o_np`` (:64) and ``fft_conv`` (:149) are on this slice's path. The FFTs
are ``torch.fft`` (cuFFT on the card). Arrays are NCHW.
"""
from __future__ import annotations

import numpy as np
import torch


def fft2(x: torch.Tensor) -> torch.Tensor:
    """2-D FFT over the last two axes."""
    return torch.fft.fft2(x)


def ifft2(x: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D FFT over the last two axes."""
    return torch.fft.ifft2(x)


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


def fft_conv(x: torch.Tensor, FB: torch.Tensor) -> torch.Tensor:
    """Circular convolution via the precomputed OTF: real(ifft2(FB * fft2(x)))."""
    cdt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    return ifft2(FB * fft2(x.to(cdt))).real.to(x.dtype)
