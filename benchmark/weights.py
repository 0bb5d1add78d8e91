"""Seeded weights, made on the device in one draw.

One ``torch.randn`` of every parameter's elements from a generator on the
device, then each parameter's slice scaled and cast to the type it is
served in. The same dict is handed to the program's model and, upcast to
float32, to the reference. The parameters, their order and their init
kinds are the denoiser family's (``reference/<family>.py::param_shapes``).
Scales by kind: ``fan_in`` weights N(0, 1/fan_in); ``zero_init`` weights,
the layers the published model initialises to zero, a tenth of that, so
that the whole network shapes the output; ``bias`` and ``norm_shift``
N(0, (0.1 / sqrt(n))^2) for n of them; ``norm_scale`` 1.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

NORM = ("norm_scale", "norm_shift")


def dtype(name: str) -> torch.dtype:
    """The torch type a configuration names ("bfloat16", "float32", ...)."""
    t = getattr(torch, name, None)
    if not isinstance(t, torch.dtype):
        raise ValueError(f"{name!r} is not a torch type")
    return t


def served_dtype(name: str, kind: str, precision: dict) -> torch.dtype:
    """The type a parameter is served in: the configuration's torso type,
    float32 for the norms' affines and the name prefixes
    ``precision["float32_params"]`` lists (the time embedding, the final
    conv)."""
    if kind in NORM or name.startswith(tuple(precision.get("float32_params", ()))):
        return torch.float32
    return dtype(precision["torso"])


def make(shapes: List[Tuple[str, Tuple[int, ...], str]], seed: int, device,
         precision: dict) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the served weights for ``seed``; ``shapes`` is the
    family's ``param_shapes(arch)``."""
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = int(np.prod(shape))
        w = z[at:at + n].view(shape)
        at += n
        if kind in ("fan_in", "zero_init"):
            fan_in = int(np.prod(shape[1:]))
            std = 1.0 / np.sqrt(fan_in)
            if kind == "zero_init":
                std *= 0.1
            w = w * std
        elif kind == "norm_scale":
            w = torch.ones_like(w)
        elif kind in ("bias", "norm_shift"):
            w = w * (0.1 / np.sqrt(shape[0]))
        else:
            raise ValueError(f"{name}: unknown init kind {kind!r}")
        out[name] = w.to(served_dtype(name, kind, precision))
    return out


def float32(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The served weights as float32 values, for the reference."""
    return {k: v.float() for k, v in weights.items()}
