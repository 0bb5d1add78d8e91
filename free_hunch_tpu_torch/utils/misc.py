"""Misc infrastructure: seeding, shape checks, profiler spans, the infinite
sampler and a parameter summary.

Counterpart of ``free_hunch_tpu/utils/misc.py``. ``set_random_seed``
returns a seeded ``torch.Generator`` where the JAX package returns a PRNG
key; ``profiled_region`` is a ``torch.profiler.record_function`` span.
"""
from __future__ import annotations

import contextlib
import random
from typing import Iterator, Optional

import numpy as np
import torch


def set_random_seed(seed: int, rank: int = 0, device="cpu") -> torch.Generator:
    """Seed numpy's and ``random``'s global generators per (seed, rank), as
    the JAX package does, and return a ``torch.Generator`` on ``device``
    seeded by the same pair."""
    s = (seed * 2**20 + rank) % (2**31 - 1)
    np.random.seed(s)
    random.seed(s)
    return torch.Generator(device=device).manual_seed(s)


def assert_shape(arr, ref_shape) -> None:
    """Shape assertion with None wildcards."""
    if arr.ndim != len(ref_shape):
        raise AssertionError(f"wrong rank: got {arr.ndim}, expected {len(ref_shape)}")
    for i, (got, want) in enumerate(zip(arr.shape, ref_shape)):
        if want is not None and got != want:
            raise AssertionError(f"wrong size for dim {i}: got {got}, expected {want}")


@contextlib.contextmanager
def profiled_region(name: str):
    """Named span in ``torch.profiler`` traces."""
    with torch.profiler.record_function(name):
        yield


def profiled_function(fn):
    def wrapper(*args, **kwargs):
        with profiled_region(fn.__name__):
            return fn(*args, **kwargs)
    wrapper.__name__ = fn.__name__
    return wrapper


class InfiniteSampler:
    """Infinite shuffled index stream sharded across ranks."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        if dataset_size <= 0 or not 0 <= window_size <= 1:
            raise ValueError(f"need dataset_size > 0 and 0 <= window_size <= 1, got "
                             f"{dataset_size}, {window_size}")
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def count_parameters(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def print_param_summary(module: torch.nn.Module, max_rows: Optional[int] = 40) -> str:
    """Tabular parameter summary: name, shape, count, then the total."""
    rows = [("parameter", "shape", "count")]
    for name, p in list(module.named_parameters())[:max_rows]:
        rows.append((name, str(tuple(p.shape)), str(p.numel())))
    rows.append(("TOTAL", "", str(count_parameters(module))))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    out = "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows)
    print(out)
    return out
