"""Reading a ``torch.profiler`` trace of a short stretch of guided calls:
the device's busy time (the union of its kernels and copies), the idle
gaps labelled by what the host was doing, kernel time by name, and the
device time under named host spans."""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Tuple


class Trace:
    """The facts of one profiled stretch. Times in seconds. ``kernels``:
    (name, start, end) of every device operation; ``spans``: name -> list
    of the device seconds of the operations each host span launched;
    ``window_s``: the stretch's length on the host clock."""

    def __init__(self, kernels: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]],
                 spans: Dict[str, List[float]], window_s: float):
        self.kernels, self.host, self.spans, self.window_s = kernels, host, spans, window_s
        self.busy = _union([(s, e) for _, s, e in kernels])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernel_seconds(self, match) -> float:
        """Device seconds of the operations whose name satisfies ``match``."""
        return sum(e - s for n, s, e in self.kernels if match(n))

    def top_ops(self, n: int = 10) -> List[list]:
        by = Counter()
        for name, s, e in self.kernels:
            by[name[:160]] += e - s
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time between device operations, summed by the host
        activity under way at each gap's middle (the innermost host span or
        operator there), the ``n`` largest."""
        if not self.busy:
            return []
        by = Counter()
        host = sorted(self.host, key=lambda h: h[1])
        opened: List[Tuple[str, float, float]] = []   # started by the current gap, by start
        at = 0
        for (_, a), (b, _) in zip(self.busy[:-1], self.busy[1:]):
            mid = 0.5 * (a + b)
            while at < len(host) and host[at][1] <= mid:
                opened.append(host[at])
                at += 1
            while opened and opened[-1][2] < mid:   # ended before this gap: no later gap is in it
                opened.pop()
            by[opened[-1][0][:160] if opened else "no host activity"] += b - a
        return [[k, v] for k, v in by.most_common(n)]


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read(prof, window_s: float, span_names=()) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    kernels, host = [], []
    spans: Dict[str, List[float]] = defaultdict(list)
    events = prof.events()
    for e in events:
        if e.device_type == DeviceType.CPU:
            host.append((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
            if e.name in span_names:
                spans[e.name].append(e.device_time_total * 1e-6)
    # the device side of a host span (a user annotation) is no operation
    named = {h[0] for h in host} | set(span_names)
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in named and \
                not getattr(e, "is_user_annotation", False):
            kernels.append((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return Trace(kernels, host, dict(spans), window_s)
