"""The program's own tracer (``free_hunch_tpu_torch/utils/profiling.py``) as
the per-layer readers see it: its snapshot of the traced stretch, the
stretch's guided calls (``mech.call`` spans), a timed span's wall per call,
and the card's idle time under a program span.

The program gathers while a profiler records, which in a run of the
benchmark is the traced stretch alone. A program without the tracer gives
None to every reader."""
from __future__ import annotations

from bisect import bisect_right
from typing import Optional


def snapshot() -> Optional[dict]:
    """``profiling.snapshot()``, or None where the program has no tracer."""
    try:
        from free_hunch_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def calls(snap: Optional[dict]) -> int:
    """The guided calls the tracer saw."""
    return snap["calls"].get("mech.call", 0) if snap else 0


def wall_ms_per_call(name: str) -> Optional[float]:
    """The timed span ``name``'s wall (on a card, the device time between
    its events) per guided call, ms."""
    snap = snapshot()
    n = calls(snap)
    if not n or name not in snap["device_s"]:
        return None
    return snap["device_s"][name] / n * 1e3


def idle_ms_per_call(ctx: dict, name: str) -> Optional[float]:
    """The card's idle time per guided call, ms, in the gaps between its
    operations whose middle lies inside a host span ``name`` of the traced
    stretch (``devtrace.Trace.idle_gaps``'s gaps, put under the program's
    span instead of the innermost operator)."""
    tr, n = ctx.get("trace"), calls(snapshot())
    if tr is None or not tr.busy or not n:
        return None
    spans = sorted((s, e) for nm, s, e in tr.host if nm == name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    idle = 0.0
    for (_, a), (b, _) in zip(tr.busy[:-1], tr.busy[1:]):
        k = bisect_right(starts, 0.5 * (a + b)) - 1
        if k >= 0 and 0.5 * (a + b) <= spans[k][1]:
            idle += b - a
    return idle / n * 1e3
