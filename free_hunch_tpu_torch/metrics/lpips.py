"""LPIPS (Learned Perceptual Image Patch Similarity), VGG variant.

Counterpart of ``free_hunch_tpu/metrics/lpips_jax.py``: the torchvision
VGG16 feature stack (convs + ReLU + max pools up to relu5_3) with the
official LPIPS input scaling, unit-normalised feature differences and the
five 1x1 linear heads of richzhang/PerceptualSimilarity
``lpips.LPIPS(net='vgg')``. Weights load from the npz that
``convert_torch_weights`` writes, the JAX package's format, from an explicit
path: the port reads no environment variable. The convolutions are f32 at
full precision (``use_full_f32``), as the JAX package's are.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from free_hunch_tpu_torch import check_full_f32, resolve_device, use_full_f32

# torchvision vgg16.features conv indices
VGG16_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# max pool after the ReLU of these convs
VGG16_POOL_AFTER = {2, 7, 14, 21}
# convs whose ReLU output is an LPIPS feature tap (relu1_2 ... relu5_3)
VGG16_TAPS = (2, 7, 14, 21, 28)
TAP_CHANNELS = (64, 128, 256, 512, 512)

# official scaling layer constants (PerceptualSimilarity lpips/lpips.py)
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def convert_torch_weights(vgg_features_state: Dict[str, np.ndarray],
                          lin_heads: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Build the weights npz dict from upstream tensors.

    vgg_features_state: ``{'<idx>.weight': OIHW, '<idx>.bias': (O,)}`` for the
    13 conv indices of torchvision ``vgg16().features`` (keys may carry a
    ``features.`` prefix). lin_heads: ``{'lins.<i>.model.1.weight': (1,C,1,1)}``
    (or ``lin<i>``) for i in 0..4, the official LPIPS linear heads."""
    out = {}
    for idx in VGG16_CONV_IDS:
        for base in (f"{idx}", f"features.{idx}"):
            wk, bk = f"{base}.weight", f"{base}.bias"
            if wk in vgg_features_state:
                out[f"conv{idx}_w"] = np.asarray(vgg_features_state[wk], np.float32)
                out[f"conv{idx}_b"] = np.asarray(vgg_features_state[bk], np.float32)
                break
        else:
            raise KeyError(f"missing vgg16 features conv {idx} weights")
    for i in range(5):
        for key in (f"lins.{i}.model.1.weight", f"lin{i}", f"lins.{i}.weight"):
            if key in lin_heads:
                w = np.asarray(lin_heads[key], np.float32).reshape(-1)
                if w.shape[0] != TAP_CHANNELS[i]:
                    raise ValueError(f"lin head {i}: expected {TAP_CHANNELS[i]} "
                                     f"channels, got {w.shape[0]}")
                out[f"lin{i}"] = w
                break
        else:
            raise KeyError(f"missing LPIPS linear head {i}")
    return out


def needed_keys():
    return ([f"conv{i}_w" for i in VGG16_CONV_IDS] + [f"conv{i}_b" for i in VGG16_CONV_IDS]
            + [f"lin{i}" for i in range(5)])


def load_weights(weights_path: str) -> Dict[str, np.ndarray]:
    """Load the converted npz; a missing file or key raises."""
    if not os.path.exists(weights_path):
        raise FileNotFoundError(f"LPIPS weights {weights_path!r} do not exist (convert the "
                                f"upstream state dicts with metrics/lpips.py::"
                                f"convert_torch_weights)")
    with np.load(weights_path) as blob:
        missing = [k for k in needed_keys() if k not in blob]
        if missing:
            raise KeyError(f"LPIPS weights {weights_path!r} are incomplete: missing "
                           f"{missing[0]} (+{len(missing) - 1} more)")
        return {k: np.asarray(blob[k], np.float32) for k in needed_keys()}


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """``forward(a, b)`` -> (B,) LPIPS distances of (B, 3, H, W) images in
    [-1, 1]."""

    def __init__(self, params: Dict[str, np.ndarray]):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, torch.as_tensor(np.asarray(v, np.float32)))
        self.register_buffer("shift", torch.as_tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.as_tensor(_SCALE).reshape(1, 3, 1, 1))

    def _vgg_taps(self, x: torch.Tensor):
        """The VGG16 feature stack; returns the 5 LPIPS tap activations."""
        taps = []
        for idx in VGG16_CONV_IDS:
            x = F.relu(F.conv2d(x, getattr(self, f"conv{idx}_w"),
                                getattr(self, f"conv{idx}_b"), padding=1))
            if idx in VGG16_TAPS:
                taps.append(x)
            if idx in VGG16_POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        check_full_f32(a)
        fa = self._vgg_taps((a - self.shift) / self.scale)
        fb = self._vgg_taps((b - self.shift) / self.scale)
        total = 0.0
        for i, (x, y) in enumerate(zip(fa, fb)):
            d = (_unit_normalize(x) - _unit_normalize(y)) ** 2
            w = getattr(self, f"lin{i}")[None, :, None, None]
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(-2, -1))
        return total


def lpips_forward(params: Dict[str, np.ndarray], a: torch.Tensor, b: torch.Tensor):
    """LPIPS distance per sample of (B, 3, H, W) images in [-1, 1]."""
    return LPIPS(params).to(a.device)(a, b)


def make_lpips(weights_path: str, device=None) -> LPIPS:
    """The LPIPS module on ``device`` (default CUDA) from a weights npz; sets
    the port's precision policy (``use_full_f32``)."""
    use_full_f32()
    return LPIPS(load_weights(weights_path)).to(resolve_device(device)).eval()
