"""Orthogonal-transform registry and lazy diagonal covariances.

Counterpart of ``free_hunch_tpu/ops/ortho.py``: ``OrthoTransform`` (the
identity without a type), the registry with 'dct' (``ops/dct.py``'s
matmul transform) and 'dwt' (the orthonormal Haar wavelet, ``haar_dwt2``
/ ``haar_idwt2``, average and difference butterflies over the last two
axes), and ``LazyOTCovariance`` (W^T diag(v) W). Every transform is linear
and orthonormal, so its adjoint is its inverse.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from free_hunch_tpu_torch.ops.dct import dct_2d, idct_2d

__OT__ = {}

_SQRT2 = math.sqrt(2.0)


def register_ot(name: str):
    def wrapper(factory):
        __OT__[name] = factory
        return factory
    return wrapper


class OrthoTransform:
    """Callable transform with ``.inv``; the identity when no type is given."""

    def __init__(self, ortho_tf_type: Optional[str] = None, **kwargs):
        self.ortho_tf_type = ortho_tf_type
        if ortho_tf_type is not None:
            self._fwd, self._inv = __OT__[ortho_tf_type](**kwargs)

    def __call__(self, x):
        if self.ortho_tf_type is None:
            return x
        return self._fwd(x)

    def inv(self, x):
        if self.ortho_tf_type is None:
            return x
        return self._inv(x)


@register_ot("dct")
def _dct_factory():
    return dct_2d, idct_2d


def haar_dwt2(x: torch.Tensor, level: int = 3) -> torch.Tensor:
    """Orthonormal 2-D Haar wavelet decomposition over the last two axes,
    in the nested quadrant layout (LL in the top-left)."""
    out = x.clone()
    size_h, size_w = x.shape[-2], x.shape[-1]
    for _ in range(level):
        sub = out[..., :size_h, :size_w]
        a, b = sub[..., 0::2, :], sub[..., 1::2, :]
        rows = torch.cat([(a + b) / _SQRT2, (a - b) / _SQRT2], dim=-2)
        a, b = rows[..., :, 0::2], rows[..., :, 1::2]
        out[..., :size_h, :size_w] = torch.cat([(a + b) / _SQRT2, (a - b) / _SQRT2], dim=-1)
        size_h //= 2
        size_w //= 2
    return out


def haar_idwt2(x: torch.Tensor, level: int = 3) -> torch.Tensor:
    """Inverse of ``haar_dwt2``."""
    h, w = x.shape[-2], x.shape[-1]
    out = x.clone()
    for size_h, size_w in [(h >> i, w >> i) for i in range(level)][::-1]:
        sub = out[..., :size_h, :size_w]
        lo, hi = sub[..., :, :size_w // 2], sub[..., :, size_w // 2:]
        rows = torch.stack([(lo + hi) / _SQRT2, (lo - hi) / _SQRT2], dim=-1).reshape(sub.shape)
        lo, hi = rows[..., :size_h // 2, :], rows[..., size_h // 2:, :]
        out[..., :size_h, :size_w] = torch.stack(
            [(lo + hi) / _SQRT2, (lo - hi) / _SQRT2], dim=-2).reshape(rows.shape)
    return out


@register_ot("dwt")
def _dwt_factory(level: int = 3, wavelet: str = "haar"):
    if wavelet != "haar":
        raise ValueError(f"only the Haar wavelet is implemented, got {wavelet!r}")
    return (lambda x: haar_dwt2(x, level)), (lambda x: haar_idwt2(x, level))


class LazyOTCovariance:
    """C = W^T diag(v) W for an OrthoTransform W; forward == transpose."""

    def __init__(self, ortho_tf: OrthoTransform, variance: torch.Tensor):
        self.ortho_tf = ortho_tf
        self.variance = variance

    def __call__(self, x):
        return self.ortho_tf.inv(self.variance * self.ortho_tf(x))

    forward = __call__
    transpose = __call__
