"""Codecs between storage uint8 and model space.

Counterpart of ``free_hunch_tpu/data/encoders.py`` (``Encoder``,
``StandardRGBEncoder``). The SD-VAE latent encoder is not ported yet.
"""
from __future__ import annotations

import torch


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
