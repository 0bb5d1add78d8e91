"""Bundled measurement/covariance data assets, read by path.

Counterpart of ``free_hunch_tpu/operators/assets.py`` (:26-70). The data
files live once in the repository, under ``free_hunch_tpu/assets/``; reading
a file there is not an import of the JAX package.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                          "free_hunch_tpu", "assets")


def _path(*parts) -> str:
    return os.path.abspath(os.path.join(_ASSET_DIR, *parts))


@functools.lru_cache(maxsize=None)
def gaussian_blur_kernel() -> np.ndarray:
    """61x61 gaussian kernel, std 3.0 (sums to 1)."""
    return np.load(_path("kernels", "gaussian_ks61_std3.0.npy"))


@functools.lru_cache(maxsize=None)
def motion_blur_kernel() -> np.ndarray:
    """61x61 motion-blur kernel, intensity 0.5 (sums to 1)."""
    return np.load(_path("kernels", "motion_ks61_std0.5.npy"))


@functools.lru_cache(maxsize=None)
def bicubic_sr_kernel(scale_factor: int) -> np.ndarray:
    """25x25 bicubic kernel for x2/x3/x4 SR; x4 serves every factor above 4."""
    data = np.load(_path("kernels", "bicubic_x234.npz"))
    key = {2: "x2", 3: "x3", 4: "x4"}.get(scale_factor if scale_factor < 5 else 4, "x4")
    return data[key]


@functools.lru_cache(maxsize=None)
def dct_variance(dataset: str = "imagenet") -> np.ndarray:
    """(3, 256, 256) per-DCT-coefficient variance prior."""
    return np.load(_path(f"dct_variance_{dataset}.npz"))["dct_variance"]


@functools.lru_cache(maxsize=None)
def recon_mse(dataset: str = "imagenet") -> dict:
    """{'sigmas': (1001,), 'mse_list': (1001,)} analytic x0 variance table."""
    data = np.load(_path(f"recon_mse_{dataset}.npz"))
    return {"sigmas": data["sigmas"], "mse_list": data["mse_list"]}


def load_dct_variance_from_dir(data_dir: str) -> np.ndarray:
    """A dct_variance prior from a dataset directory (``dct_variance.npz``
    or the reference's ``dct_variance.pt``), else the bundled ImageNet one."""
    npz = os.path.join(data_dir, "dct_variance.npz")
    if os.path.exists(npz):
        return np.load(npz)["dct_variance"]
    pt = os.path.join(data_dir, "dct_variance.pt")
    if os.path.exists(pt):
        import torch
        return torch.load(pt, weights_only=True, map_location="cpu").numpy()
    return dct_variance("imagenet")
