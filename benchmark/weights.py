"""Seeded weights, made on the device in one draw.

One ``torch.randn`` of every parameter's elements from a generator on the
device, then each parameter's slice scaled and cast to the type it is
served in. The same dict is handed to the program's model and, upcast to
float32, to the reference. Scales: convolution and linear weights
N(0, 1/fan_in); the layers the published model initialises to zero (each
ResBlock's last conv, attention's proj_out, the final conv) a tenth of
that, so that the whole network shapes the output; biases and GroupNorm
shifts N(0, (0.1 / sqrt(n))^2) for n of them; GroupNorm scales 1.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reference import unet as ref_unet

ZERO_INIT = ("out_layers.3.weight", "proj_out.weight")


def dtype(name: str) -> torch.dtype:
    """The torch type a configuration names ("bfloat16", "float32", ...)."""
    t = getattr(torch, name, None)
    if not isinstance(t, torch.dtype):
        raise ValueError(f"{name!r} is not a torch type")
    return t


def served_dtype(name: str, precision: dict) -> torch.dtype:
    """The type a parameter is served in: the configuration's torso type,
    float32 for the time embedding, the GroupNorm affines and the final
    conv (``precision["float32_params"]`` lists those name prefixes)."""
    if ref_unet.is_norm(name) or name.startswith(tuple(precision.get("float32_params", ()))):
        return torch.float32
    return dtype(precision["torso"])


def make(arch: ref_unet.Arch, seed: int, device, precision: dict) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the served weights for ``seed``."""
    shapes = ref_unet.param_shapes(arch)
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        w = z[at:at + n].view(shape)
        at += n
        if name.endswith(".weight") and len(shape) > 1:
            fan_in = int(np.prod(shape[1:]))
            std = 1.0 / np.sqrt(fan_in)
            if name.endswith(ZERO_INIT) or name == "out.2.weight":
                std *= 0.1
            w = w * std
        elif name.endswith(".weight") and ref_unet.is_norm(name):
            w = torch.ones_like(w)
        else:
            w = w * (0.1 / np.sqrt(shape[0]))
        out[name] = w.to(served_dtype(name, precision))
    return out


def float32(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The served weights as float32 values, for the reference."""
    return {k: v.float() for k, v in weights.items()}
