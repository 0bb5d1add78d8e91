"""The ``toyve`` family on the program's side: the toy network as a
module whose norm goes through the port's ``ops/groupnorm.py::
groupnorm_silu``, under a continuous-sigma VE preconditioner that the
sampler's schedule reads (``round_sigma`` the identity, ``sigma_min``,
``sigma_max``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from free_hunch_tpu_torch.ops.groupnorm import groupnorm_silu

FREQ = 16.0


class Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.groups = min(c // 4, 32)

    def forward(self, x):
        y = groupnorm_silu(x.permute(0, 2, 3, 1), self.weight, self.bias, self.groups, 1e-6, True)
        return y.permute(0, 3, 1, 2)


class Net(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_in = nn.Conv2d(3, c, 3, padding=1)
        self.emb = nn.Linear(2, c)
        self.norm = Norm(c)
        self.conv_out = nn.Conv2d(c, 3, 3, padding=1)

    def forward(self, x, c_noise):
        e = torch.stack([torch.sin(FREQ * c_noise), torch.cos(FREQ * c_noise)], dim=-1)
        h = self.conv_in(x) + self.emb(e)[:, :, None, None]
        return self.conv_out(self.norm(h))


class VEPrecond(nn.Module):
    sigma_min, sigma_max = 0.01, 1348.0

    def __init__(self, net: Net):
        super().__init__()
        self.net = net

    def round_sigma(self, sigma):
        return np.asarray(sigma, np.float64)

    def forward(self, x, sigma):
        x = x.float()
        s = torch.as_tensor(sigma, dtype=torch.float32).to(x.device).reshape(-1)
        s = s.expand(x.shape[0])
        D = torch.clamp(x + s[:, None, None, None] * self.net(x, torch.log(0.5 * s)), -1.0, 1.0)
        return D, (s ** 2 / (1 + s ** 2))[:, None, None, None].expand_as(D)


def build(config: dict, weights, device, **options):
    with torch.device(device):
        net = Net(int(config["model"]["channels"]))
    net.load_state_dict(weights)
    net = net.eval().requires_grad_(False)
    return net, VEPrecond(net)


def norm_modules(model) -> list:
    return [m for m in model.modules() if isinstance(m, Norm)]
