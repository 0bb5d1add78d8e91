"""Orthonormal 2-D DCT-II / DCT-III as dense f32 matmuls.

Counterpart of ``free_hunch_tpu/ops/dct.py``. For 256x256 images each
transform is two 256x256x256 matmuls per channel, which cuBLAS runs in full
f32: the JAX package runs these at ``Precision.HIGHEST`` because the basis
change feeds the BFGS secant pairs, so TF32 must stay off
(``free_hunch_tpu_torch.use_full_f32``; checked here on CUDA tensors).
Transforms act on the last two axes of arbitrarily batched inputs.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from free_hunch_tpu_torch import check_full_f32


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    # Orthonormal DCT-II matrix: C[k, m] = s_k * cos(pi * (2m + 1) * k / (2n)).
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    mat = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    mat *= np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return mat.astype(np.float64)


_matrices: dict = {}


def dct_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The (n, n) orthonormal DCT-II matrix C, so dct(x) = C @ x."""
    key = (n, dtype, torch.device(device or "cpu"))
    mat = _matrices.get(key)
    if mat is None:
        mat = torch.as_tensor(_dct_matrix_np(n), dtype=dtype, device=key[2])
        _matrices[key] = mat
    return mat


def dct_2d(x: torch.Tensor) -> torch.Tensor:
    """Type-II orthonormal DCT over the last two axes: C_h @ x @ C_w^T."""
    check_full_f32(x)
    ch = dct_matrix(x.shape[-2], x.dtype, x.device)
    cw = dct_matrix(x.shape[-1], x.dtype, x.device)
    return torch.matmul(torch.matmul(ch, x), cw.T)


def idct_2d(x: torch.Tensor) -> torch.Tensor:
    """Type-III DCT (inverse of dct_2d) over the last two axes: C_h^T @ x @ C_w."""
    check_full_f32(x)
    ch = dct_matrix(x.shape[-2], x.dtype, x.device)
    cw = dct_matrix(x.shape[-1], x.dtype, x.device)
    return torch.matmul(torch.matmul(ch.T, x), cw)


def dct_1d(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Orthonormal DCT-II along one axis."""
    check_full_f32(x)
    x = x.movedim(dim, -1)
    c = dct_matrix(x.shape[-1], x.dtype, x.device)
    return torch.matmul(x, c.T).movedim(-1, dim)


def idct_1d(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Orthonormal DCT-III (inverse DCT-II) along one axis."""
    check_full_f32(x)
    x = x.movedim(dim, -1)
    c = dct_matrix(x.shape[-1], x.dtype, x.device)
    return torch.matmul(x, c).movedim(-1, dim)
