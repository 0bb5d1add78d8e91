"""Profiling and tracing helpers.

Counterpart of ``free_hunch_tpu/utils/profiling.py``:

* ``trace(log_dir)``: ``torch.profiler`` over a block, CPU and CUDA
  activity, exported at its end as a gzipped Chrome/Perfetto trace
  (``log_dir/trace.json.gz``, which Perfetto opens as it is);
* the tracer: ``span``, ``count``, ``tally``, ``host_read``, ``snapshot``
  and ``reset``, on while a ``torch.profiler`` session records (below);
* ``annotate(name)``: a named span inside a trace (``span``);
* ``PhaseTimer``: wall time per named phase, ending each phase with
  ``torch.cuda.synchronize`` when its result lies on a card (the JAX
  package's ``block_until_ready``: CUDA launches return before the work
  is done);
* ``device_memory_stats()``: the card's allocator counters
  (``torch.cuda.memory_stats``).

The tracer's switch is the profiler's own: tracing is on exactly while a
``torch.profiler`` session records (``torch.autograd.profiler.
_is_profiler_enabled``, a global that the backward's threads read too).
Off, a span, a count or a tally costs that one flag read. On:

* ``span(name, device=...)`` enters ``record_function(name)``, on the
  profiler's clock, the clock of the CUDA activity too, so a trace can put
  each idle gap of the card under a program span; with ``device`` it also
  times the span: two pooled CUDA timing events on the current stream
  (their distance, the span's device wall, is folded in by ``snapshot``),
  or the host clock on a CPU device, whose work is synchronous;
* ``count(name, n)``: a host counter;
* ``tally(name, index, labels)``: a device-side histogram in a buffer on
  ``index``'s device, no host read;
* ``host_read(value, read)``: ``read(value)`` (default ``bool``) for a
  device-to-host read, in a ``host.read`` span and counted as
  ``host_reads``.

``snapshot()`` synchronises once, folds the timing events and returns the
span calls, counts, device walls (seconds) and tallies gathered since
``reset()``, which ``trace`` calls on entry; they add up over the process's
profiled time. The names the port uses: ``mech.call`` (each guided call,
``guidance/mechanisms.py``), ``fh.denoise``, ``fh.cov_update``,
``fh.solve``, ``fh.guide`` (Free Hunch's stages, device-timed),
``host.read`` and ``host_reads``, ``cg.solves``, the tallies ``cg.rows``
(why each CG row stopped, ``ops/cg.py::STOP_REASONS``) and ``cg.no_step``.
"""
from __future__ import annotations

import contextlib
import os
import time
import types
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from free_hunch_tpu_torch import resolve_device

TRACE_FILE = "trace.json.gz"

_calls: Dict[str, int] = defaultdict(int)
_counts: Dict[str, int] = defaultdict(int)
_walls: Dict[str, float] = defaultdict(float)
_pending: List[tuple] = []       # (name, start event, end event), not yet folded
_events: List[torch.cuda.Event] = []   # the pool
_tallies: Dict[str, tuple] = {}   # name -> (labels, counts at or above each bin)
_OFF = contextlib.nullcontext()


def on() -> bool:
    """Whether a ``torch.profiler`` session records: the tracer's switch."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "args", "device", "range", "start")

    def __init__(self, name, args, device):
        self.name, self.args, self.device = name, args, device

    def __enter__(self):
        _calls[self.name] += 1
        self.range = torch.profiler.record_function(self.name, self.args)
        self.range.__enter__()
        if self.device is not None:
            if self.device.type == "cuda":
                self.start = _events.pop() if _events else torch.cuda.Event(enable_timing=True)
                self.start.record(torch.cuda.current_stream(self.device))
            else:
                self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            if self.device.type == "cuda":
                end = _events.pop() if _events else torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
                _pending.append((self.name, self.start, end))
            else:
                _walls[self.name] += time.perf_counter() - self.start
        self.range.__exit__(*exc)
        return False


def span(name: str, device=False, args: Optional[dict] = None):
    """A named span of the program (see the module docstring). ``device``:
    the device whose work the span times (a ``torch.device`` or its name),
    or False. ``args``: a few values, recorded as the range's argument
    string."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, None if args is None else
                 " ".join(f"{k}={v}" for k, v in args.items()),
                 torch.device(device) if device else None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    if _autograd_profiler._is_profiler_enabled:
        _counts[name] += n


def tally(name: str, index: torch.Tensor, labels) -> None:
    """Add one to bin ``index[i]`` of the histogram ``name`` (bins named by
    ``labels``) for each entry of the integer tensor ``index``, on its
    device; the card is not read. The buffer holds, per bin b, the entries
    at b or above (``snapshot`` takes the differences): comparisons, a
    cast and sums, kernels a solve runs anyway, where an ``index_add_`` or
    a ``bincount`` would load a module of its own in the first traced call
    (or read the card)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if name not in _tallies:
        _tallies[name] = (tuple(labels),
                          torch.zeros(len(labels), dtype=torch.float32, device=index.device))
    buf = _tallies[name][1]
    for b in range(len(labels)):
        buf[b].add_((index >= b).to(buf.dtype).sum())


def host_read(value, read=bool):
    """``read(value)``: a read of the card by the host (a stopping test, a
    branch), in a ``host.read`` span and counted as ``host_reads``."""
    if not _autograd_profiler._is_profiler_enabled:
        return read(value)
    _counts["host_reads"] += 1
    with _Span("host.read", None, None):
        return read(value)


def snapshot() -> dict:
    """What the tracer gathered since ``reset``: {"calls": span entries by
    name, "counts": host counters, "device_s": each timed span's summed
    wall in seconds (device time between its events on a card, host time
    on a CPU), "tallies": {name: {label: count}}}. Synchronises the card
    once when timing events are pending."""
    if _pending:
        for dev in {e.device for _, _, e in _pending}:
            torch.cuda.synchronize(dev)
        for name, e0, e1 in _pending:
            _walls[name] += e0.elapsed_time(e1) * 1e-3
            _events.extend((e0, e1))
        _pending.clear()
    tallies = {}
    for k, (labels, buf) in _tallies.items():
        at_or_above = [int(v) for v in buf.tolist()] + [0]
        tallies[k] = {lab: at_or_above[b] - at_or_above[b + 1] for b, lab in enumerate(labels)}
    return {"calls": dict(_calls), "counts": dict(_counts), "device_s": dict(_walls),
            "tallies": tallies}


def reset() -> None:
    """Forget what the tracer gathered."""
    for _, e0, e1 in _pending:
        _events.extend((e0, e1))
    for d in (_calls, _counts, _walls, _tallies):
        d.clear()
    _pending.clear()


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block into ``log_dir/trace.json.gz``; yields the
    ``torch.profiler.profile`` object (``key_averages()`` and the rest).
    The tracer is reset on entry and on throughout: ``snapshot()`` after
    the block reads what the program gathered in it.
    ``device`` (default CUDA, which raises without a card) adds CUDA
    activity to the CPU's; ``device="cpu"`` records the CPU only."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region inside a trace: ``span(name)``."""
    return span(name)


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
