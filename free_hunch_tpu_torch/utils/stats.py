"""Cross-process moment-accumulating statistics.

Counterpart of ``free_hunch_tpu/utils/stats.py`` (``report``, ``report0``,
``Collector``, ``_sync``). Moments [count, sum, sum of squares] accumulate
on the host in float64 per name; ``Collector.update`` sums them over the
process group (``parallel/dist.py``) and resets the local accumulation.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np

from free_hunch_tpu_torch.parallel import dist

_NUM_MOMENTS = 3  # [count, sum, sum of squares]
_counters: Dict[str, np.ndarray] = {}
_rank0_only = False


def init_multiprocessing(rank: int = 0, sync_device=None):
    """Record whether ``report0`` is a no-op here (every rank but 0)."""
    global _rank0_only
    _rank0_only = rank != 0


def report(name: str, value) -> None:
    """Accumulate the moments of ``value`` under ``name``."""
    arr = np.asarray(value, np.float64).ravel()
    if arr.size == 0:
        return
    moments = np.array([arr.size, arr.sum(), np.square(arr).sum()], np.float64)
    _counters[name] = _counters.get(name, np.zeros(_NUM_MOMENTS)) + moments


def report0(name: str, value) -> None:
    """Accumulate only on rank 0."""
    if not _rank0_only:
        report(name, value)


class Collector:
    """Snapshot and query of the accumulated counters whose names match
    ``regex``."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep = keep_previous
        self._moments: Dict[str, np.ndarray] = {}
        self.update()

    def names(self):
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self):
        if not self._keep:
            self._moments.clear()
        for name, m in _sync(self.names()):
            # keep_previous: a sync that brought no new samples keeps the
            # previous window's statistics instead of zeroing them
            if not self._keep or m[0] != 0:
                self._moments[name] = m

    def _get(self, name):
        return self._moments.get(name, np.zeros(_NUM_MOMENTS))

    def num(self, name):
        return int(self._get(name)[0])

    def mean(self, name):
        m = self._get(name)
        return float(m[1] / m[0]) if m[0] else float("nan")

    def std(self, name):
        m = self._get(name)
        if m[0] in (0, 1):
            return 0.0 if m[0] else float("nan")
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean**2, 0)))

    def as_dict(self):
        return {name: dict(num=self.num(name), mean=self.mean(name),
                           std=self.std(name)) for name in self.names()}

    def __getitem__(self, name):
        return self.mean(name)


def _sync(names):
    """(name, moments summed over ranks) for the union of every rank's
    ``names``, and the local accumulation reset. The name sets may differ
    across ranks (``report0`` creates counters on rank 0 only), so the
    ranks first agree on the sorted union, then gather one row per name of
    it; the float64 moments travel exactly."""
    if dist.get_world_size() <= 1:
        union = list(names)
    else:
        union = sorted(set().union(*dist.all_gather_object(sorted(names))))
    if not union:
        return []
    local = np.stack([_counters.get(n, np.zeros(_NUM_MOMENTS)) for n in union])
    summed = dist.all_gather(local).sum(axis=0) if dist.get_world_size() > 1 else local
    out = []
    for i, n in enumerate(union):
        out.append((n, summed[i].copy()))
        _counters[n] = np.zeros(_NUM_MOMENTS)
    return out
