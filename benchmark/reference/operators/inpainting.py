"""Random-pixel inpainting: one mask per image, a fraction p ~ U(lo, hi)
of the pixels dropped (exactly floor(res^2 p) of them, shared by the
channels), drawn from the run's generator; y = A (x + sigma_y n). The
program takes the same mask."""
from __future__ import annotations

import torch

from reference.freehunch import Mask


def masks(gen, batch: int, res: int, lo: float, hi: float) -> torch.Tensor:
    """(batch, 3, res, res), 1 = observed."""
    out = torch.ones((batch, 1, res * res))
    for b in range(batch):
        p = lo + (hi - lo) * float(torch.rand((), generator=gen, dtype=torch.float64))
        out[b, 0, torch.randperm(res * res, generator=gen)[:int(res * res * p)]] = 0.0
    return out.reshape(batch, 1, res, res).expand(batch, 3, res, res).contiguous()


def make(op: dict, batch: int, res: int, gen, device) -> Mask:
    mask = masks(gen("mask"), batch, res, *op["drop_fraction"]).to(device)
    ref = Mask(mask, op["sigma_y"])
    ref.program = dict(mask=mask)
    return ref
