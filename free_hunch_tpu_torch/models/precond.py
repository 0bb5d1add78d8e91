"""EDM-style sigma parameterisation around the raw UNet.

Counterpart of ``IDDPMLinearPrecond`` and ``IDDPMCosinePrecond`` in
``free_hunch_tpu/models/precond.py`` (:28-45, :66-217). Denoiser contract,
consumed by the guidance mechanisms:
    D(x, sigma) -> (x0_mean, x0_var)
with D(x, sigma) = clip(x - sigma F(c_in x, c_noise), -1, 1). The linear
class maps the learned-sigma channel to an x0 posterior variance (Peng et
al. Eq. 22); the cosine class has no such mapping on its grid and returns
the MLE variance sigma^2 / (1 + sigma^2). ``VEPrecond`` is score_sde's
continuous-sigma VE SDE around NCSN++ (no grid; its own data range).

With ``qscales`` (an ``int8_static`` UNet's calibration table,
``models/calibrate.py``), every call first selects the stage scales for its
sigma (``_select_qscales``, the JAX package's ``precond.py:47-62``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from free_hunch_tpu_torch.ops.quant import _QuantSite


def _linear_sigma_grid(beta_min: float, beta_max: float, M: int) -> np.ndarray:
    """u[j] = sigma of reversed index j for the linear-beta DDPM schedule,
    with u[M] = 0 appended as the terminal zero-noise level."""
    betas = np.concatenate([[0.0], np.linspace(beta_min, beta_max, M)])
    alpha_bar = np.cumprod(1.0 - betas)[::-1]
    return np.sqrt((1.0 - alpha_bar) / alpha_bar)


def _cosine_sigma_grid(C_1: float, C_2: float, M: int) -> np.ndarray:
    """The iDDPM cosine schedule's grid, u[M] = 0 its terminal level."""
    def alpha_bar(j):
        return np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2

    u = np.zeros(M + 1)
    for j in range(M, 0, -1):
        u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1)
    return u


def _select_qscales(sigmas: torch.Tensor, sigma) -> torch.Tensor:
    """Index of the calibration stage nearest to the call's sigma, taken
    from ``sigma.reshape(-1)[0]`` (first index on ties). A batch must share
    one sigma, as the sampler's does: a batch of mixed sigmas gets the first
    row's stage for every row. ``sigma`` a tensor: the lookup stays on the
    device; a host number: on the host."""
    if isinstance(sigma, torch.Tensor):
        s0 = sigma.float().reshape(-1)[0].to(sigmas.device)
        return torch.argmin(torch.abs(sigmas - s0))
    s0 = np.float32(np.asarray(sigma, np.float32).reshape(-1)[0])
    return torch.tensor(int(np.argmin(np.abs(sigmas.cpu().numpy() - s0))))


class _Precond(nn.Module):
    """What both preconditioners share: the sigma grid ``u`` (ascending
    reversed index, u[M] = 0), ``round_sigma`` with a host numpy branch
    (schedule setup; equal to the JAX package's bit for bit) and a tensor
    branch, the static-int8 stage selection and the forward. ``forward(x,
    sigma)`` takes sigma as a host float or a tensor.

    qscales: optional (sigmas (S,), {site: (S,) scales}) table of an
    ``int8_static`` model; sites are the torch names of its static int8
    modules (``models/calibrate.py``). Each forward writes the nearest
    stage's scales into those modules' ``act_scale`` buffers."""

    def __init__(self, model: nn.Module, u: np.ndarray, img_resolution: int,
                 img_channels: int, label_dim: int, M: int,
                 qscales: Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]]):
        super().__init__()
        self.model = model
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.label_dim = label_dim
        self.M = M
        self.u_np = np.asarray(u, np.float32)
        self.sigma_min = float(u[M - 1])
        self.sigma_max = float(u[0])
        self.register_buffer("u", torch.as_tensor(self.u_np), persistent=False)
        self.qscales = qscales
        self._qsites = []
        if qscales is not None:
            sigmas, table = qscales
            sites = [(name, m) for name, m in model.named_modules()
                     if isinstance(m, _QuantSite) and m.mode == "static"]
            names = [name for name, _ in sites]
            self._qsites = [m for _, m in sites]
            missing = sorted(set(names) - set(table))
            if not names or missing:
                raise KeyError(f"qscales table lacks static int8 sites {missing[:4]} "
                               f"(model has {len(names)})")
            self.register_buffer("qscale_sigmas", torch.as_tensor(
                np.asarray(sigmas, np.float32)), persistent=False)
            self.register_buffer("qscale_table", torch.as_tensor(np.stack(
                [np.asarray(table[n], np.float32) for n in names], axis=1)),
                persistent=False)                                   # (S, sites)

    def round_sigma(self, sigma, return_index: bool = False):
        """Snap sigma to the nearest grid value (first index on ties)."""
        if not isinstance(sigma, torch.Tensor):
            s = np.asarray(sigma, np.float32)
            idx = np.argmin(np.abs(s.reshape(-1)[:, None] - self.u_np[None, :]), axis=1)
            return (idx if return_index else self.u_np[idx]).reshape(np.shape(sigma))
        s = sigma.float()
        idx = torch.argmin(torch.abs(s.reshape(-1)[:, None] - self.u[None, :]), dim=1)
        return (idx if return_index else self.u[idx]).reshape(s.shape)

    # c_noise = M - c_noise_offset - idx, the grid index the UNet was trained on
    c_noise_offset = 0

    def _x0_var(self, v: torch.Tensor, c_noise: torch.Tensor, sigma: torch.Tensor,
                D_x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, sigma, y: Optional[torch.Tensor] = None):
        """D(x, sigma) -> (x0_mean in [-1, 1], x0_var); x is (N, C, H, W)."""
        x = x.float()
        n = x.shape[0]
        if isinstance(sigma, torch.Tensor):
            sigma = sigma.float().reshape(-1).broadcast_to((n,)).to(x.device)
            idx = self.round_sigma(sigma, return_index=True)
        else:
            s_host = np.broadcast_to(np.asarray(sigma, np.float32).reshape(-1), (n,)).copy()
            idx = torch.as_tensor(self.round_sigma(s_host, return_index=True),
                                  device=x.device)
            sigma = torch.as_tensor(s_host, device=x.device)
        if self.label_dim and y is None:
            y = torch.zeros((n,), dtype=torch.int64, device=x.device)
        c_out = -sigma
        c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
        c_noise = (self.M - self.c_noise_offset - idx).float()
        if self._qsites:
            row = self.qscale_table[_select_qscales(self.qscale_sigmas, sigma)]
            for j, m in enumerate(self._qsites):
                m.act_scale = row[j]
        out = self.model(c_in[:, None, None, None] * x, c_noise, y=y)
        F_x = out[:, :self.img_channels]
        D_x = torch.clamp(x + c_out[:, None, None, None] * F_x.float(), -1.0, 1.0)
        return D_x, self._x0_var(out[:, self.img_channels:], c_noise, sigma, D_x)


class IDDPMLinearPrecond(_Precond):
    """Linear-beta iDDPM preconditioner: c_noise = M - idx, and the
    learned-sigma channel mapped to an x0 posterior variance."""

    def __init__(self, model: nn.Module, img_resolution: int, img_channels: int,
                 label_dim: int = 0, beta_min: float = 0.0001, beta_max: float = 0.02,
                 M: int = 1000,
                 qscales: Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]] = None):
        super().__init__(model, _linear_sigma_grid(beta_min, beta_max, M), img_resolution,
                         img_channels, label_dim, M, qscales)
        betas = np.concatenate([[0.0], np.linspace(beta_min, beta_max, M)])
        alphas_cumprod = np.cumprod(1.0 - betas)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        with np.errstate(invalid="ignore", divide="ignore"):
            # index 0 (the prepended zero-beta level) is 0/0 and never used
            post_var = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            post_c1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        self.register_buffer("posterior_variance", torch.as_tensor(
            np.nan_to_num(post_var).astype(np.float32)), persistent=False)
        self.register_buffer("posterior_mean_coef1", torch.as_tensor(
            np.nan_to_num(post_c1).astype(np.float32)), persistent=False)

    def _x0_var(self, v, c_noise, sigma, D_x):
        t = c_noise.long()
        pv = self.posterior_variance[t][:, None, None, None]
        pm1 = self.posterior_mean_coef1[t][:, None, None, None]
        return torch.clamp((v - pv) / torch.square(pm1), min=1e-6)


class IDDPMCosinePrecond(_Precond):
    """Cosine-schedule iDDPM preconditioner: c_noise = M - 1 - idx, the
    grid's sigma_min is u[M - 1], and x0_var is the MLE variance
    sigma^2 / (1 + sigma^2) (no learned-variance mapping on this grid)."""
    c_noise_offset = 1

    def __init__(self, model: nn.Module, img_resolution: int, img_channels: int,
                 label_dim: int = 0, C_1: float = 0.001, C_2: float = 0.008, M: int = 1000,
                 qscales: Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]] = None):
        super().__init__(model, _cosine_sigma_grid(C_1, C_2, M), img_resolution,
                         img_channels, label_dim, M, qscales)

    def _x0_var(self, v, c_noise, sigma, D_x):
        return (sigma**2 / (1 + sigma**2))[:, None, None, None].expand(D_x.shape)


PRECONDS = {"linear": IDDPMLinearPrecond, "cosine": IDDPMCosinePrecond}


class VEPrecond(nn.Module):
    """score_sde's variance-exploding SDE around a network of continuous
    sigma (NCSN++, ``models/ncsnpp.py``): no sigma grid (``round_sigma`` is
    the identity), sigma in [``sigma_min``, ``sigma_max``] (score_sde's
    0.01 and 1348 for FFHQ 1024), and the network's score.

    The network was trained on data in its own range: [0, 1] where the
    configuration's ``centered`` is False (score_sde's ``data.centered``),
    which it maps to [-1, 1] inside. The port's images lie in [-1, 1], so
    the call maps them to that range, x_m = c x + b (c = 1/2, b = 1/2; c = 1,
    b = 0 where centered), at sigma_m = c sigma, and maps the denoiser back:

        D(x, sigma) = clip(x + c sigma^2 s(x_m, sigma_m), -1, 1)

    with s the network's score (its output under ``scale_by_sigma``: its
    last layer's h over sigma_m, so that the sum is x + sigma h, EDM's
    ``VEPrecond`` with c_noise = log(sigma_m)). The variance is the MLE
    sigma^2 / (1 + sigma^2), as ``IDDPMCosinePrecond``'s. ``forward(x,
    sigma)`` takes sigma as a host float or a tensor; ``y`` (labels) is
    accepted and unused."""
    label_dim = 0

    def __init__(self, model: nn.Module, img_resolution: int, img_channels: int = 3,
                 sigma_min: float = 0.01, sigma_max: float = 1348.0, centered: bool = False):
        super().__init__()
        self.model = model
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.sigma_min, self.sigma_max = float(sigma_min), float(sigma_max)
        self.c, self.b = (1.0, 0.0) if centered else (0.5, 0.5)

    @classmethod
    def around(cls, model: nn.Module) -> "VEPrecond":
        """The preconditioner of an NCSN++ model, from its configuration
        (``model.cfg``: image size, channels, sigma range, data range), on
        the model's device."""
        cfg = model.cfg
        return cls(model, img_resolution=cfg.image_size, img_channels=cfg.num_channels,
                   sigma_min=cfg.sigma_min, sigma_max=cfg.sigma_max, centered=cfg.centered)

    def round_sigma(self, sigma):
        """The identity: a continuous-sigma network has no grid."""
        if isinstance(sigma, torch.Tensor):
            return sigma
        return np.asarray(sigma, np.float64)

    def forward(self, x: torch.Tensor, sigma, y: Optional[torch.Tensor] = None):
        """D(x, sigma) -> (x0_mean in [-1, 1], x0_var); x is (N, C, H, W)."""
        x = x.float()
        n = x.shape[0]
        if isinstance(sigma, torch.Tensor):
            sigma = sigma.float().reshape(-1).broadcast_to((n,)).to(x.device)
        else:
            sigma = torch.as_tensor(np.broadcast_to(
                np.asarray(sigma, np.float32).reshape(-1), (n,)).copy(), device=x.device)
        score = self.model(self.c * x + self.b, self.c * sigma)
        s4 = sigma[:, None, None, None]
        D_x = torch.clamp(x + (self.c * s4 ** 2) * score.float(), -1.0, 1.0)
        return D_x, (s4 ** 2 / (1 + s4 ** 2)).expand(D_x.shape)
