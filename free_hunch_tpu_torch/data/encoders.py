"""Codecs between storage uint8 and model space.

Counterpart of ``free_hunch_tpu/data/encoders.py``: ``StandardRGBEncoder``
(uint8 <-> [-1, 1]) and ``StabilityVAEEncoder`` (SD-VAE latents on
``models/vae.py``). The VAE's weights come from an explicit path (the JAX
package's npz, see ``models/convert.py::load_vae_npz``), never from the
environment; the published sd-vae-ft-mse weights are not in the
repository.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from free_hunch_tpu_torch import randn, resolve_device
from free_hunch_tpu_torch.models import convert
from free_hunch_tpu_torch.models.vae import AutoencoderKL, VAEConfig, load_diffusers_state_dict


class Encoder:
    def init(self, device=None):
        pass

    def encode(self, x):
        raise NotImplementedError

    def decode(self, z):
        raise NotImplementedError


class StandardRGBEncoder(Encoder):
    """uint8 [0, 255] CHW -> float32 [-1, 1] and back."""

    def encode(self, x) -> torch.Tensor:
        return torch.as_tensor(x).float() / 127.5 - 1.0

    def decode(self, z) -> torch.Tensor:
        # torch.round rounds half to even, as jnp.round does
        z = torch.as_tensor(z).float()
        return torch.clamp(torch.round((z + 1.0) * 127.5), 0, 255).to(torch.uint8)


class StabilityVAEEncoder(Encoder):
    """Stable-Diffusion VAE latents: ``encode_pixels`` gives cat(mean, std)
    of the latent posterior of x / 255; ``encode_latents`` samples z = mean
    + std * eps and maps it affinely from (raw_mean, raw_std) to
    (final_mean, final_std); ``decode`` inverts the map, decodes, clamps to
    [0, 1] and truncates x 255 to uint8. The VAE runs ``batch_size`` images
    at a time.

    ``weights``: the JAX package's converted sd-vae-ft-mse npz, read by
    ``init()``; ``init(params=...)`` takes the parameters instead, as the
    JAX package's flax tree ({'params': ...}) or a diffusers state dict.
    ``cfg`` is the architecture (default sd-vae-ft-mse's)."""

    def __init__(self, vae_name: str = "stabilityai/sd-vae-ft-mse",
                 raw_mean=(5.81, 3.25, 0.12, -2.15), raw_std=(4.17, 4.62, 3.71, 3.28),
                 final_mean=0.0, final_std=0.5, batch_size: int = 8,
                 weights: Optional[str] = None, cfg=None):
        self.vae_name = vae_name
        scale = (np.float32(final_std) / np.asarray(raw_std, np.float32)).reshape(1, -1, 1, 1)
        bias = np.float32(final_mean) - np.asarray(raw_mean, np.float32).reshape(1, -1, 1, 1) \
            * scale
        self.scale, self.bias = torch.from_numpy(scale), torch.from_numpy(bias)
        self.batch_size = int(batch_size)
        self.weights = weights
        self.cfg = cfg if cfg is not None else VAEConfig()
        self.vae = None
        self.device = None
        self._gen = None

    def init(self, device=None, params=None):
        """Build the VAE on ``device`` (default CUDA, which raises without a
        card) from ``params`` or, without them, from ``weights``."""
        if self.vae is not None and params is None:
            return
        dev = resolve_device(device)
        vae = AutoencoderKL(self.cfg)
        if params is None:
            if not self.weights or not os.path.exists(self.weights):
                raise RuntimeError(
                    f"StabilityVAEEncoder needs the converted {self.vae_name} weights: "
                    f"weights={self.weights!r} names no file (an npz of the JAX package's "
                    f"parameter tree)")
            params = convert.load_vae_npz(self.weights)
        if "params" in params:
            vae.load_state_dict(convert.vae_state_dict_from_flax(params), strict=True)
        else:
            load_diffusers_state_dict(vae, params)
        self.vae = vae.to_device(dev).eval().requires_grad_(False)
        self.device = dev
        self.scale, self.bias = self.scale.to(dev), self.bias.to(dev)

    def encode_pixels(self, x) -> torch.Tensor:
        """uint8 pixels (N, 3, H, W) -> raw latents cat(mean, std), (N, 2 *
        latent_channels, H / f, W / f) on the encoder's device."""
        x = torch.as_tensor(x).to(self._require()).float() / 255.0
        n, _, h, w = x.shape
        f = self.cfg.downscale
        if n == 0:
            return torch.zeros((0, 2 * self.cfg.latent_channels, h // f, w // f),
                               device=x.device)
        outs = self._run(self.vae.encode, x)
        return torch.cat([torch.cat([m for m, _ in outs]), torch.cat([s for _, s in outs])],
                         dim=1)

    def encode_latents(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Raw latents -> final latents (z = mean + std * eps, then the
        affine map). eps comes from ``generator`` (a CPU generator: the
        card draws what the CPU does), or, without one, from an internal
        generator that advances on every call."""
        x = torch.as_tensor(x).float()
        mean, std = x.chunk(2, dim=1)
        if generator is None:
            if self._gen is None:
                self._gen = torch.Generator().manual_seed(0)
            generator = self._gen
        z = mean + randn(mean.shape, generator, device=mean.device) * std
        return z * self.scale.to(z.device) + self.bias.to(z.device)

    def encode(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encode_latents(self.encode_pixels(x), generator=generator)

    def decode(self, z) -> torch.Tensor:
        """Final latents -> uint8 pixels (N, 3, H * f, W * f)."""
        z = torch.as_tensor(z).to(self._require()).float()
        raw = (z - self.bias) / self.scale
        n, _, h, w = raw.shape
        f = self.cfg.downscale
        if n == 0:
            return torch.zeros((0, self.cfg.out_channels, h * f, w * f), dtype=torch.uint8,
                               device=raw.device)
        x = torch.cat(self._run(self.vae.decode, raw))
        return (x.clamp(0, 1) * 255.0).to(torch.uint8)

    def _require(self) -> torch.device:
        if self.vae is None:
            raise RuntimeError("StabilityVAEEncoder: call init() first")
        return self.device

    def _run(self, fn, x) -> list:
        """``fn`` on ``batch_size`` images at a time."""
        with torch.no_grad():
            return [fn(x[i:i + self.batch_size]) for i in range(0, x.shape[0], self.batch_size)]
