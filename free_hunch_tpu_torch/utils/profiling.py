"""Profiling and tracing helpers.

Counterpart of ``free_hunch_tpu/utils/profiling.py``:

* ``trace(log_dir)``: ``torch.profiler`` over a block, CPU and CUDA
  activity, exported at its end as a gzipped Chrome/Perfetto trace
  (``log_dir/trace.json.gz``, which Perfetto opens as it is);
* ``annotate(name)``: a named span inside a trace
  (``torch.profiler.record_function``);
* ``PhaseTimer``: wall time per named phase, ending each phase with
  ``torch.cuda.synchronize`` when its result lies on a card (the JAX
  package's ``block_until_ready``: CUDA launches return before the work
  is done);
* ``device_memory_stats()``: the card's allocator counters
  (``torch.cuda.memory_stats``).
"""
from __future__ import annotations

import contextlib
import os
import time
import types
from collections import defaultdict
from typing import Dict, Optional

import torch

from free_hunch_tpu_torch import resolve_device

TRACE_FILE = "trace.json.gz"


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block into ``log_dir/trace.json.gz``; yields the
    ``torch.profiler.profile`` object (``key_averages()`` and the rest).
    ``device`` (default CUDA, which raises without a card) adds CUDA
    activity to the CPU's; ``device="cpu"`` records the CPU only."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


def _block(result) -> None:
    """Wait for the card's work on every CUDA tensor of ``result`` (a
    tensor, or lists, tuples and dicts of them)."""
    stack, devices = [result], set()
    while stack:
        r = stack.pop()
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                devices.add(r.device)
        elif isinstance(r, (list, tuple)):
            stack.extend(r)
        elif isinstance(r, dict):
            stack.extend(r.values())
    for d in devices:
        torch.cuda.synchronize(d)


class PhaseTimer:
    """Wall-clock accounting per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        """``with timer.phase('solve') as ph: out = f(x); ph.set(out)``: the
        handle's ``set`` names the result to wait for at the block's end."""
        handle = types.SimpleNamespace(result=None)
        handle.set = lambda r: setattr(handle, "result", r)
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            _block(handle.result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def measure(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, timed to the end of its work."""
        with self.phase(name) as ph:
            out = fn(*args, **kwargs)
            ph.set(out)
        return out

    def summary(self) -> str:
        return "\n".join(
            f"{name}: total {self.totals[name]:.3f}s over {self.counts[name]} calls "
            f"({self.totals[name] / max(self.counts[name], 1) * 1e3:.1f} ms/call)"
            for name in sorted(self.totals))


def device_memory_stats(device=None) -> Optional[dict]:
    """The allocator's counters of a card (``torch.cuda.memory_stats``;
    ``allocated_bytes.all.peak`` is the peak since the last
    ``torch.cuda.reset_peak_memory_stats``). ``device`` defaults to CUDA,
    which raises without a card; a CPU device has no such counters: None."""
    dev = resolve_device(device)
    return torch.cuda.memory_stats(dev) if dev.type == "cuda" else None
