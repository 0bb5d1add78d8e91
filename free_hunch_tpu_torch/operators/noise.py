"""Measurement-noise models (clean / gaussian / poisson).

Counterpart of ``free_hunch_tpu/operators/noise.py`` (:14-67). Draws take an
explicit ``torch.Generator`` where the JAX package takes a key.
"""
from __future__ import annotations

import torch

_NOISE = {}


def register_noise(name: str):
    def wrapper(cls):
        if name in _NOISE:
            raise NameError(f"noise {name!r} already registered")
        _NOISE[name] = cls
        return cls
    return wrapper


def get_noise(name: str, **kwargs):
    if name not in _NOISE:
        raise NameError(f"noise {name!r} is not defined")
    noiser = _NOISE[name](**kwargs)
    noiser.__name__ = name
    return noiser


class Noise:
    def __call__(self, data, generator=None):
        return self.forward(data, generator)


@register_noise(name="clean")
class Clean(Noise):
    def __init__(self, **kwargs):
        pass

    def forward(self, data, generator=None):
        return data


@register_noise(name="gaussian")
class GaussianNoise(Noise):
    def __init__(self, sigma=0.1, **kwargs):
        self.sigma = sigma

    def forward(self, data, generator=None):
        if generator is None:
            raise ValueError("gaussian noise needs a torch.Generator")
        n = torch.randn(data.shape, generator=generator, dtype=data.dtype, device=data.device)
        return data + self.sigma * n


@register_noise(name="poisson")
class PoissonNoise(Noise):
    """Shot noise at the given photon rate on [0,1]-scaled uint8 intensities."""

    def __init__(self, rate=1.0, **kwargs):
        self.rate = rate

    def forward(self, data, generator=None):
        if generator is None:
            raise ValueError("poisson noise needs a torch.Generator")
        lam = torch.clamp((data + 1.0) / 2.0, 0.0, 1.0) * 255.0 * self.rate
        draw = torch.poisson(lam, generator=generator).to(data.dtype) / 255.0 / self.rate
        return torch.clamp(draw * 2.0 - 1.0, -1.0, 1.0)
