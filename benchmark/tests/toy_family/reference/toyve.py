"""The ``toyve`` denoiser family's reference, for the benchmark's tests: a
family that is not ADM and has no sigma grid. Two 3x3 convolutions around
one GroupNorm+SiLU (min(C / 4, 32) groups, eps 1e-6, as NCSN++ has them),
a noise embedding of c_noise = log(sigma / 2) added per channel, under the
VE preconditioner D = x + sigma F(x, c_noise) with continuous sigma in
[0.01, 1348]. Plain float32; imports nothing of the program."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6
FREQ = 16.0
SIGMA_RANGE = (0.01, 1348.0)


@dataclasses.dataclass(frozen=True)
class Arch:
    image_size: int
    channels: int


def arch_of(model: dict) -> Arch:
    return Arch(image_size=int(model["image_size"]), channels=int(model["channels"]))


def groups(c: int) -> int:
    return min(c // 4, 32)


def param_shapes(a: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    c = a.channels
    return [("conv_in.weight", (c, 3, 3, 3), "fan_in"), ("conv_in.bias", (c,), "bias"),
            ("emb.weight", (c, 2), "fan_in"), ("emb.bias", (c,), "bias"),
            ("norm.weight", (c,), "norm_scale"), ("norm.bias", (c,), "norm_shift"),
            ("conv_out.weight", (3, c, 3, 3), "zero_init"), ("conv_out.bias", (3,), "bias")]


def net(p: Dict[str, torch.Tensor], a: Arch, x, c_noise, rounding=None):
    r = rounding or (lambda t: t)
    h = F.conv2d(r(x), r(p["conv_in.weight"]), p["conv_in.bias"], padding=1)
    e = torch.stack([torch.sin(FREQ * c_noise), torch.cos(FREQ * c_noise)], dim=-1)
    h = h + F.linear(e, p["emb.weight"], p["emb.bias"])[:, :, None, None]
    h = F.silu(F.group_norm(h, groups(a.channels), p["norm.weight"], p["norm.bias"], EPS))
    return F.conv2d(r(h), r(p["conv_out.weight"]), p["conv_out.bias"], padding=1)


def preclamp(p, a: Arch, x: torch.Tensor, sigma: float, rounding=None) -> torch.Tensor:
    n = x.shape[0]
    sig = torch.full((n,), float(np.float32(sigma)), dtype=torch.float32, device=x.device)
    return x + sig[:, None, None, None] * net(p, a, x, torch.log(0.5 * sig), rounding)


def snap_grid(a: Arch):
    return None


def sigma_range(a: Arch) -> Tuple[float, float]:
    return SIGMA_RANGE


def forward_flops(a: Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    hw, c = a.image_size ** 2, a.channels
    return {torso: batch * (2 * 3 * c * 9 * hw + 2 * c * 3 * 9 * hw + 2 * 2 * c)}


def input_backward_flops(a: Arch, torso: str, batch: int = 1) -> Dict[str, float]:
    hw, c = a.image_size ** 2, a.channels
    return {torso: batch * (2 * 3 * c * 9 * hw + 2 * c * 3 * 9 * hw)}


def norm_inputs(a: Arch) -> List[Tuple[int, int, int]]:
    return [(a.channels, a.image_size, a.image_size)]
