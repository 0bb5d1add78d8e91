"""Image quality metrics: PSNR, SSIM and LPIPS.

Counterpart of ``free_hunch_tpu/metrics/quality.py``. PSNR and SSIM follow
skimage's semantics (SSIM: 7x7 uniform window, C1 = (0.01 L)^2,
C2 = (0.03 L)^2, sample covariance N/(N-1), channel-averaged, mean over the
valid region). ``lpips_fn`` gives the native VGG LPIPS of
``metrics/lpips.py`` when a weights file is given, else a flagged proxy.
The JAX package's third route, the ``lpips`` pip package, is left out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from free_hunch_tpu_torch import resolve_device


def psnr(ref, img, data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the last three axes: (B,) for
    batched CHW inputs."""
    ref = torch.as_tensor(ref).float()
    img = torch.as_tensor(img).float()
    dims = tuple(range(ref.dim() - 3, ref.dim())) if ref.dim() >= 3 else None
    mse = torch.mean((ref - img) ** 2, dim=dims)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode uniform filter over the last two axes (an exact f32 mean
    of each window: no TF32 path)."""
    lead = x.shape[:-2]
    out = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]), win, stride=1)
    return out.reshape(lead + out.shape[-2:])


def ssim(ref, img, data_range: float = 255.0, win_size: int = 7,
         K1: float = 0.01, K2: float = 0.03) -> torch.Tensor:
    """Structural similarity of (..., C, H, W) images, skimage-compatible
    (channels averaged): one value per leading index, (B,) for a batch."""
    ref = torch.as_tensor(ref).float()
    img = torch.as_tensor(img).float()
    ux = _uniform_filter(ref, win_size)
    uy = _uniform_filter(img, win_size)
    uxx = _uniform_filter(ref * ref, win_size)
    uyy = _uniform_filter(img * img, win_size)
    uxy = _uniform_filter(ref * img, win_size)
    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)
         / ((ux**2 + uy**2 + C1) * (vx + vy + C2)))
    # the valid-mode filter already gives skimage's cropped region
    return torch.mean(S, dim=(-3, -2, -1))


def lpips_fn(net: str = "vgg", weights_path: Optional[str] = None, device=None):
    """Return ``lpips(a, b) -> float`` (batch mean) on [-1, 1] NCHW images,
    computed on ``device`` (default CUDA), with ``fn.is_proxy``.

    With ``weights_path`` (the npz of ``lpips.convert_torch_weights``) it is
    the native LPIPS of ``metrics/lpips.py``; a path that does not exist or
    lacks a key raises. Without one it is a perceptual proxy (multi-scale
    gradient similarity), not comparable to published LPIPS numbers and
    flagged ``is_proxy`` (``lpips_is_proxy`` in results.json)."""
    if net != "vgg":
        raise ValueError(f"only the vgg LPIPS is ported, got net={net!r}")
    dev = resolve_device(device)
    if weights_path is not None:
        from free_hunch_tpu_torch.metrics import lpips

        model = lpips.make_lpips(weights_path, device=dev)

        def fn(a, b):
            with torch.no_grad():
                return float(torch.mean(model(torch.as_tensor(a, device=dev).float(),
                                              torch.as_tensor(b, device=dev).float())))

        fn.is_proxy = False
        return fn

    def fn(a, b):
        return float(_perceptual_proxy(torch.as_tensor(a, device=dev).float(),
                                       torch.as_tensor(b, device=dev).float()))

    fn.is_proxy = True
    return fn


def _perceptual_proxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-scale normalised feature distance as a stand-in perceptual
    metric (gradient magnitudes at 3 dyadic scales). Monotone with
    distortion but not LPIPS-calibrated."""
    def feats(x):
        fs = []
        for _ in range(3):
            gx = x[..., :, 1:] - x[..., :, :-1]
            gy = x[..., 1:, :] - x[..., :-1, :]
            fs.append(torch.mean(gx**2) + torch.mean(gy**2))
            x = 0.25 * (x[..., ::2, ::2] + x[..., 1::2, ::2]
                        + x[..., ::2, 1::2] + x[..., 1::2, 1::2])
        return torch.stack(fs)

    fa, fb = feats(a), feats(b)
    return torch.mean(torch.abs(fa - fb) / (fa + fb + 1e-8)) + 0.5 * torch.mean((a - b) ** 2)
