"""Blur-kernel synthesis (gaussian / random motion PSFs).

The port's copy of ``free_hunch_tpu/operators/blurkernel.py`` (:14-35): the
same numpy code. Host numpy at operator setup.
"""
from __future__ import annotations

import numpy as np

from free_hunch_tpu_torch.operators.motionblur import MotionKernel


def gaussian_kernel(kernel_size: int = 61, std: float = 3.0) -> np.ndarray:
    """Separable 2-D gaussian PSF normalised to sum 1."""
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    g = np.exp(-0.5 * (ax / std) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def motion_kernel(kernel_size: int = 61, intensity: float = 0.5,
                  rng=None) -> np.ndarray:
    """Random motion PSF (see operators.motionblur.MotionKernel)."""
    return MotionKernel(size=(kernel_size, kernel_size), intensity=intensity,
                        rng=rng).kernelMatrix


def make_kernel(blur_type: str, kernel_size: int, std: float, rng=None) -> np.ndarray:
    """Blurkernel-compatible dispatch: blur_type in {'gaussian', 'motion'}."""
    if blur_type == "gaussian":
        return gaussian_kernel(kernel_size, std)
    if blur_type == "motion":
        return motion_kernel(kernel_size, std, rng=rng)
    raise ValueError(f"unknown blur_type {blur_type!r}")
