"""Inpainting mask generation (box / random / extreme).

Counterpart of ``free_hunch_tpu/operators/masks.py`` (:14-63). The masks
are drawn from a ``torch.Generator`` on the host, so they cannot equal the
JAX package's ``jax.random`` draws; their semantics are the same: exactly
floor(H*W*p) masked pixels for p ~ U(prob_range), or a box whose side and
margins lie in range. A mask is (1, C, H, W) float32, 1 = observed.
"""
from __future__ import annotations

from typing import Optional

import torch


def _uniform(gen, lo: float, hi: float) -> float:
    return lo + (hi - lo) * float(torch.rand((), generator=gen, dtype=torch.float64))


def _randint(gen, lo: int, hi: int) -> int:
    """An integer in [lo, hi), or lo when the range is empty (as
    ``jax.random.randint`` clamps)."""
    return lo if hi <= lo else int(torch.randint(lo, hi, (), generator=gen))


def random_pixel_mask(generator: Optional[torch.Generator], image_size: int, prob_range,
                      channels: int = 3) -> torch.Tensor:
    """Drop a uniform-random fraction p ~ U(prob_range) of pixels, shared
    across channels: exactly floor(H*W*p) of them, without replacement."""
    total = image_size * image_size
    prob = _uniform(generator, float(prob_range[0]), float(prob_range[1]))
    n_masked = int(total * prob)
    keep = torch.ones(total)
    keep[torch.randperm(total, generator=generator)[:n_masked]] = 0.0
    return keep.reshape(1, 1, image_size, image_size).expand(
        1, channels, image_size, image_size).contiguous()


def box_mask(generator: Optional[torch.Generator], image_size: int, len_range,
             channels: int = 3, margin=(16, 16), extreme: bool = False) -> torch.Tensor:
    """Zero out a random square-ish region with side in [len_range) and at
    least ``margin`` from the border; ``extreme`` keeps only the box."""
    lo, hi = int(len_range[0]), int(len_range[1])
    h = _randint(generator, lo, hi)
    w = _randint(generator, lo, hi)
    t = _randint(generator, margin[0], image_size - margin[0] - h)
    l = _randint(generator, margin[1], image_size - margin[1] - w)  # noqa: E741
    mask = torch.ones(image_size, image_size)
    mask[t:t + h, l:l + w] = 0.0
    if extreme:
        mask = 1.0 - mask
    return mask.reshape(1, 1, image_size, image_size).expand(
        1, channels, image_size, image_size).contiguous()


def generate_mask(generator: Optional[torch.Generator], mask_opt: dict,
                  channels: int = 3) -> torch.Tensor:
    """Dispatch on mask_opt['mask_type'] in {'box', 'random', 'extreme'}."""
    mt = mask_opt["mask_type"]
    size = mask_opt.get("image_size", 256)
    if mt == "random":
        return random_pixel_mask(generator, size, mask_opt["mask_prob_range"], channels)
    if mt in ("box", "extreme"):
        return box_mask(generator, size, mask_opt["mask_len_range"], channels,
                        mask_opt.get("margin", (16, 16)), extreme=mt == "extreme")
    raise ValueError(f"unknown mask_type {mt!r}")
