"""FID (Frechet Inception Distance).

Counterpart of ``free_hunch_tpu/metrics/fid.py``:

* the InceptionV3 pool3 extractor of pytorch-fid (2048-d, with its
  ``count_include_pad=False`` average pools in the A, C and E blocks and
  the max-pool branch of the last E block), an ``nn.Module`` of f32
  convolutions at full precision (``use_full_f32``), BN folded into each
  conv at load time;
* ``FeatureStats``, streaming first and second moments in float64, exact
  and mergeable;
* ``frechet_distance`` with scipy's ``sqrtm`` and pytorch-fid's jitter
  retry for a singular product.

Weights load from the JAX package's npz format (``convert_torch_weights``)
at an explicit path; the port reads no environment variable. Without a
path the extractor takes deterministic seeded random weights, bitwise the
JAX package's, and results carry ``fid_is_proxy: true``: a random-feature
Frechet distance is a valid two-sample discrepancy but not comparable to
published FID. ``allgather_merge`` sums the moments of every rank of the
process group exactly.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from free_hunch_tpu_torch import check_full_f32, resolve_device, use_full_f32
from free_hunch_tpu_torch.parallel import dist

# ---------------------------------------------------------------------------
# InceptionV3 (pytorch-fid variant) — architecture table.
# Each BasicConv2d is (name, in_ch, out_ch, kernel(h,w), stride, pad(h,w)).
# Names mirror the torchvision/pytorch-fid state_dict so conversion is 1:1.
# ---------------------------------------------------------------------------

STEM = (
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    ("maxpool", None, None, None, None, None),
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    ("maxpool", None, None, None, None, None),
)

# (block_type, name, in_channels, param) — param is pool_features (A),
# channels_7x7 (C), or None.
MIXED = (
    ("A", "Mixed_5b", 192, 32),
    ("A", "Mixed_5c", 256, 64),
    ("A", "Mixed_5d", 288, 64),
    ("B", "Mixed_6a", 288, None),
    ("C", "Mixed_6b", 768, 128),
    ("C", "Mixed_6c", 768, 160),
    ("C", "Mixed_6d", 768, 160),
    ("C", "Mixed_6e", 768, 192),
    ("D", "Mixed_7a", 768, None),
    ("E1", "Mixed_7b", 1280, None),   # avg pool branch (count_include_pad=False)
    ("E2", "Mixed_7c", 2048, None),   # pytorch-fid: MAX pool branch
)

FEATURE_DIM = 2048
_BN_EPS = 1e-3


def _block_convs(btype: str, name: str, cin: int, p) -> List[Tuple]:
    """Enumerate the BasicConv2d specs of one Mixed block, torchvision
    naming/order."""
    if btype == "A":
        return [
            (f"{name}.branch1x1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{name}.branch5x5_1", cin, 48, (1, 1), 1, (0, 0)),
            (f"{name}.branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
            (f"{name}.branch3x3dbl_1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{name}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            (f"{name}.branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
            (f"{name}.branch_pool", cin, p, (1, 1), 1, (0, 0)),
        ]
    if btype == "B":
        return [
            (f"{name}.branch3x3", cin, 384, (3, 3), 2, (0, 0)),
            (f"{name}.branch3x3dbl_1", cin, 64, (1, 1), 1, (0, 0)),
            (f"{name}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            (f"{name}.branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0)),
        ]
    if btype == "C":
        c7 = p
        return [
            (f"{name}.branch1x1", cin, 192, (1, 1), 1, (0, 0)),
            (f"{name}.branch7x7_1", cin, c7, (1, 1), 1, (0, 0)),
            (f"{name}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            (f"{name}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            (f"{name}.branch7x7dbl_1", cin, c7, (1, 1), 1, (0, 0)),
            (f"{name}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            (f"{name}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            (f"{name}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            (f"{name}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            (f"{name}.branch_pool", cin, 192, (1, 1), 1, (0, 0)),
        ]
    if btype == "D":
        return [
            (f"{name}.branch3x3_1", cin, 192, (1, 1), 1, (0, 0)),
            (f"{name}.branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
            (f"{name}.branch7x7x3_1", cin, 192, (1, 1), 1, (0, 0)),
            (f"{name}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            (f"{name}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            (f"{name}.branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0)),
        ]
    # E1 / E2
    return [
        (f"{name}.branch1x1", cin, 320, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3_1", cin, 384, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{name}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{name}.branch3x3dbl_1", cin, 448, (1, 1), 1, (0, 0)),
        (f"{name}.branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
        (f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{name}.branch_pool", cin, 192, (1, 1), 1, (0, 0)),
    ]


def all_conv_specs() -> List[Tuple]:
    specs = [s for s in STEM if s[0] != "maxpool"]
    for btype, name, cin, p in MIXED:
        specs.extend(_block_convs(btype, name, cin, p))
    return specs


# ---------------------------------------------------------------------------
# Parameters: one (scale-folded) conv per BasicConv2d.
# ---------------------------------------------------------------------------


def convert_torch_weights(state_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """pytorch-fid / torchvision ``inception_v3`` state_dict -> the weights
    npz dict. Expects per BasicConv2d ``<name>.conv.weight`` (OIHW, no bias)
    and ``<name>.bn.{weight,bias,running_mean,running_var}``."""
    out = {}
    for name, _, _, _, _, _ in all_conv_specs():
        try:
            out[f"{name}.w"] = np.asarray(state_dict[f"{name}.conv.weight"],
                                          np.float32)
            for k in ("weight", "bias", "running_mean", "running_var"):
                out[f"{name}.bn.{k}"] = np.asarray(state_dict[f"{name}.bn.{k}"],
                                                   np.float32)
        except KeyError as e:
            raise KeyError(f"missing inception weight for {name}: {e}") from e
    return out


def _fold_bn(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold inference BN into a per-conv (weight, bias) pair:
    y = conv(x) * g/sqrt(var+eps) + (beta - mean * g/sqrt(var+eps))."""
    params = {}
    for name, _, _, _, _, _ in all_conv_specs():
        w = raw[f"{name}.w"]
        g = raw[f"{name}.bn.weight"]
        beta = raw[f"{name}.bn.bias"]
        mean = raw[f"{name}.bn.running_mean"]
        var = raw[f"{name}.bn.running_var"]
        s = g / np.sqrt(var + _BN_EPS)
        params[f"{name}.w"] = (w * s[:, None, None, None]).astype(np.float32)
        params[f"{name}.b"] = (beta - mean * s).astype(np.float32)
    return params


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic He-normal random weights (the proxy extractor). BN is
    identity at init (gamma=1, beta=0, mean=0, var=1), so folding is a no-op."""
    rng = np.random.default_rng(seed)
    raw = {}
    for name, cin, cout, k, _, _ in all_conv_specs():
        fan_in = cin * k[0] * k[1]
        raw[f"{name}.w"] = rng.normal(
            0.0, np.sqrt(2.0 / fan_in), (cout, cin, k[0], k[1])).astype(np.float32)
        raw[f"{name}.bn.weight"] = np.ones(cout, np.float32)
        raw[f"{name}.bn.bias"] = np.zeros(cout, np.float32)
        raw[f"{name}.bn.running_mean"] = np.zeros(cout, np.float32)
        raw[f"{name}.bn.running_var"] = np.ones(cout, np.float32)
    return raw


def load_weights(weights_path: Optional[str] = None) -> Optional[Dict[str, np.ndarray]]:
    """Load the converted npz. Returns None only when no path is given; a
    path that does not exist or lacks a key raises: a silent swap to the
    proxy would put a proxy FID in a run its user believes comparable."""
    if not weights_path:
        return None
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"FID weights {weights_path!r} do not exist (convert the pytorch-fid "
            f"state_dict with metrics/fid.py::convert_torch_weights)")
    raw = {}
    with np.load(weights_path) as blob:
        for name, _, _, _, _, _ in all_conv_specs():
            keys = [f"{name}.w"] + [f"{name}.bn.{k}" for k in
                                    ("weight", "bias", "running_mean", "running_var")]
            missing = [k for k in keys if k not in blob]
            if missing:
                raise KeyError(
                    f"FID weights {weights_path!r} are incomplete: missing {missing[0]} "
                    f"(+{len(missing) - 1} more); regenerate with convert_torch_weights")
            for k in keys:
                raw[k] = np.asarray(blob[k], np.float32)
    return raw


# ---------------------------------------------------------------------------
# Forward pass.
# ---------------------------------------------------------------------------


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, 2)


def _pool3s1(x, kind: str):
    """3x3 stride-1 pad-1 pooling; the average divides by the in-bounds
    count (count_include_pad=False, pytorch-fid's deviation)."""
    if kind == "max":
        return F.max_pool2d(x, 3, 1, 1)
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionFeatures(nn.Module):
    """``forward(x, resize=True)``: pool3 features (B, 2048) of (B, 3, H, W)
    f32 images in [-1, 1]; inputs other than 299x299 are first resized
    bilinearly with half-pixel centres and no antialiasing, as pytorch-fid's
    ``F.interpolate(..., mode='bilinear', align_corners=False)`` does."""

    def __init__(self, folded: Dict[str, np.ndarray]):
        super().__init__()
        self._specs = {name: (stride, pad) for name, _, _, _, stride, pad in all_conv_specs()}
        for name in self._specs:
            key = name.replace(".", "__")
            self.register_buffer(f"{key}__w", torch.as_tensor(folded[f"{name}.w"]))
            self.register_buffer(f"{key}__b", torch.as_tensor(folded[f"{name}.b"]))

    def _conv(self, name, x):
        key = name.replace(".", "__")
        stride, pad = self._specs[name]
        y = F.conv2d(x, getattr(self, f"{key}__w"), getattr(self, f"{key}__b"),
                     stride=stride, padding=pad)
        return F.relu(y)

    def _mixed_a(self, name, x):
        c = self._conv
        b1 = c(f"{name}.branch1x1", x)
        b5 = c(f"{name}.branch5x5_2", c(f"{name}.branch5x5_1", x))
        b3 = c(f"{name}.branch3x3dbl_3",
               c(f"{name}.branch3x3dbl_2", c(f"{name}.branch3x3dbl_1", x)))
        bp = c(f"{name}.branch_pool", _pool3s1(x, "avg"))
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _mixed_b(self, name, x):
        c = self._conv
        b3 = c(f"{name}.branch3x3", x)
        bd = c(f"{name}.branch3x3dbl_3",
               c(f"{name}.branch3x3dbl_2", c(f"{name}.branch3x3dbl_1", x)))
        return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)

    def _mixed_c(self, name, x):
        c = self._conv
        b1 = c(f"{name}.branch1x1", x)
        b7 = c(f"{name}.branch7x7_3", c(f"{name}.branch7x7_2", c(f"{name}.branch7x7_1", x)))
        bd = c(f"{name}.branch7x7dbl_1", x)
        for i in (2, 3, 4, 5):
            bd = c(f"{name}.branch7x7dbl_{i}", bd)
        bp = c(f"{name}.branch_pool", _pool3s1(x, "avg"))
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _mixed_d(self, name, x):
        c = self._conv
        b3 = c(f"{name}.branch3x3_2", c(f"{name}.branch3x3_1", x))
        b7 = c(f"{name}.branch7x7x3_1", x)
        for i in (2, 3, 4):
            b7 = c(f"{name}.branch7x7x3_{i}", b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)

    def _mixed_e(self, name, x, pool_kind):
        c = self._conv
        b1 = c(f"{name}.branch1x1", x)
        b3 = c(f"{name}.branch3x3_1", x)
        b3 = torch.cat([c(f"{name}.branch3x3_2a", b3), c(f"{name}.branch3x3_2b", b3)], dim=1)
        bd = c(f"{name}.branch3x3dbl_2", c(f"{name}.branch3x3dbl_1", x))
        bd = torch.cat([c(f"{name}.branch3x3dbl_3a", bd),
                        c(f"{name}.branch3x3dbl_3b", bd)], dim=1)
        bp = c(f"{name}.branch_pool", _pool3s1(x, pool_kind))
        return torch.cat([b1, b3, bd, bp], dim=1)

    def forward(self, x: torch.Tensor, resize: bool = True) -> torch.Tensor:
        check_full_f32(x)
        if resize and tuple(x.shape[-2:]) != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=False)
        c = self._conv
        x = c("Conv2d_2b_3x3", c("Conv2d_2a_3x3", c("Conv2d_1a_3x3", x)))
        x = _maxpool3s2(x)
        x = c("Conv2d_4a_3x3", c("Conv2d_3b_1x1", x))
        x = _maxpool3s2(x)
        for btype, name, _, _ in MIXED:
            if btype == "A":
                x = self._mixed_a(name, x)
            elif btype == "B":
                x = self._mixed_b(name, x)
            elif btype == "C":
                x = self._mixed_c(name, x)
            elif btype == "D":
                x = self._mixed_d(name, x)
            else:
                x = self._mixed_e(name, x, "avg" if btype == "E1" else "max")
        return torch.mean(x, dim=(-2, -1))  # adaptive average pool to 1x1


def make_extractor(weights_path: Optional[str] = None, proxy_seed: int = 0, device=None):
    """(extract(x) -> (B, 2048), is_proxy) on ``device`` (default CUDA):
    real weights from ``weights_path``, else the seeded random features.
    Sets the port's precision policy (``use_full_f32``)."""
    use_full_f32()
    dev = resolve_device(device)
    raw = load_weights(weights_path)
    is_proxy = raw is None
    if is_proxy:
        raw = random_params(proxy_seed)
    net = InceptionFeatures(_fold_bn(raw)).to(dev).eval()

    def extract(x):
        with torch.no_grad():
            return net(torch.as_tensor(x, device=dev).float())

    return extract, is_proxy


# ---------------------------------------------------------------------------
# Moment accumulation + Frechet distance.
# ---------------------------------------------------------------------------


class FeatureStats:
    """Streaming, mergeable first/second moment accumulator (f64).

    Accumulates sum(x) and sum(x x^T); ``mu_sigma`` returns the sample mean
    and the unbiased covariance (pytorch-fid's ``np.cov`` default)."""

    def __init__(self, dim: int = FEATURE_DIM):
        self.dim = dim
        self.n = 0
        self.s = np.zeros(dim, np.float64)
        self.ss = np.zeros((dim, dim), np.float64)

    def add(self, feats):
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().numpy()
        f = np.asarray(feats, np.float64)
        if f.ndim != 2 or f.shape[1] != self.dim:
            raise ValueError(f"features must be (n, {self.dim}), got {f.shape}")
        self.n += f.shape[0]
        self.s += f.sum(axis=0)
        self.ss += f.T @ f

    def merge_arrays(self, n: float, s: np.ndarray, ss: np.ndarray):
        self.n += int(n)
        self.s += s
        self.ss += ss

    def mu_sigma(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError("need at least 2 samples for a covariance")
        mu = self.s / self.n
        sigma = (self.ss - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, sigma

    def save(self, path: str, is_proxy: Optional[bool] = None):
        mu, sigma = self.mu_sigma()
        extra = {} if is_proxy is None else dict(is_proxy=is_proxy)
        np.savez(path, mu=mu, sigma=sigma, n=self.n, **extra)


def allgather_merge(st: FeatureStats) -> FeatureStats:
    """The moments of every rank of the process group merged in rank order:
    equal to those of one process that added every rank's features, since
    the float64 sums travel as they are (``parallel/dist.py::all_gather``)."""
    packed = np.concatenate([[float(st.n)], st.s, st.ss.reshape(-1)])
    merged = FeatureStats(st.dim)
    for row in dist.all_gather(packed):
        merged.merge_arrays(row[0], row[1:1 + st.dim], row[1 + st.dim:].reshape(st.dim, st.dim))
    return merged


def load_ref_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as blob:
        return np.asarray(blob["mu"], np.float64), np.asarray(blob["sigma"], np.float64)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = ||mu1 - mu2||^2 + tr(S1 + S2 - 2 sqrt(S1 S2)), pytorch-fid's
    semantics with the jitter retry when sqrtm is singular."""
    import scipy.linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def compute_fid(stats: FeatureStats, ref_stats_path: str) -> float:
    mu_g, sig_g = stats.mu_sigma()
    mu_r, sig_r = load_ref_stats(ref_stats_path)
    return frechet_distance(mu_g, sig_g, mu_r, sig_r)
