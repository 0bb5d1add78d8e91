"""Bicubic (and friends) separable resize as dense matmuls.

Counterpart of ``free_hunch_tpu/operators/resize.py``: ``resize_matrix``
(:51-81) is the same host numpy (float64) code, so the matrices are equal
bit for bit; ``build_resizer`` (:84-98) returns a function on tensors that
computes ``R_h @ x @ R_w^T`` in float32 on the operator's device. On the
card the matmuls must run in full f32 (``free_hunch_tpu_torch.use_full_f32``):
in TF32 the forward moves by about 1e-3.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from free_hunch_tpu_torch import check_full_f32


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _linear(x):
    return (x + 1) * ((x >= -1) & (x < 0)) + (1 - x) * ((x >= 0) & (x <= 1))


def _box(x):
    return ((x >= -0.5) & (x < 0.5)) * 1.0


def _lanczos(n):
    def k(x):
        eps = np.finfo(np.float32).eps
        return (((np.sin(np.pi * x) * np.sin(np.pi * x / n) + eps)
                 / ((np.pi**2 * x**2 / n) + eps)) * (np.abs(x) < n))
    return k


_KERNELS = {"cubic": (_cubic, 4.0), "linear": (_linear, 2.0), "box": (_box, 1.0),
            "lanczos2": (_lanczos(2), 4.0), "lanczos3": (_lanczos(3), 6.0)}


@functools.lru_cache(maxsize=None)
def resize_matrix(in_length: int, out_length: int, scale: float,
                  kernel: str = "cubic", antialiasing: bool = True) -> np.ndarray:
    """Dense (out_length, in_length) resize matrix for one dimension.

    Matlab/imresize conventions: pixel p sits at coordinate p - 0.5; the
    output coordinate maps to input via d_new = d_old / scale with a center
    shift when out_length != in_length * scale; antialiasing stretches the
    kernel by 1/scale on downscale; out-of-range taps reflect at borders;
    weights are normalised per output pixel.
    """
    kern, width = _KERNELS[kernel]
    aa = antialiasing and scale < 1
    fixed = (lambda a: scale * kern(scale * a)) if aa else kern
    kw = width / scale if aa else width

    out_coord = np.arange(1, out_length + 1, dtype=np.float64)
    shifted = out_coord - (out_length - in_length * scale) / 2
    match = shifted / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(match - kw / 2)
    taps = int(np.ceil(kw)) + 2
    fov = (left[:, None] + np.arange(taps)[None, :] - 1).astype(np.int64)
    w = fixed(match[:, None] - fov - 1)
    s = w.sum(axis=1)
    s[s == 0] = 1.0
    w = w / s[:, None]
    # reflection padding via the mirror trick
    mirror = np.concatenate([np.arange(in_length), np.arange(in_length - 1, -1, -1)])
    fov = mirror[np.mod(fov, mirror.shape[0])]
    R = np.zeros((out_length, in_length), np.float64)
    np.add.at(R, (np.repeat(np.arange(out_length), taps), fov.ravel()), w.ravel())
    return R


def build_resizer(in_hw, scale_factor: float, kernel: str = "cubic",
                  antialiasing: bool = True, device=None) -> Callable:
    """Return f(x) resizing the last two axes of x by ``scale_factor``, with
    ``f.matrices = (R_h, R_w)``: float32 tensors on ``device``."""
    h, w = in_hw
    oh, ow = int(np.ceil(h * scale_factor)), int(np.ceil(w * scale_factor))
    Rh = torch.as_tensor(resize_matrix(h, oh, float(scale_factor), kernel,
                                       antialiasing).astype(np.float32), device=device)
    Rw = torch.as_tensor(resize_matrix(w, ow, float(scale_factor), kernel,
                                       antialiasing).astype(np.float32), device=device)

    def apply(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        check_full_f32(x)
        return Rh @ x @ Rw.T

    apply.matrices = (Rh, Rw)
    return apply
