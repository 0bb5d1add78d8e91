"""The share of CG rows, over the traced stretch's solves, that stopped
without meeting their tolerance or a proven floor: the program's tally
``cg.rows`` (``ops/cg.py::STOP_REASONS``), rows that ended in breakdown, a
non-finite residual or the iteration cap, %."""
import tracer

UNMET = ("breakdown", "nonfinite", "maxiter")


def read(ctx):
    snap = tracer.snapshot()
    rows = (snap or {}).get("tallies", {}).get("cg.rows")
    if not rows or not sum(rows.values()):
        return None
    return 100.0 * sum(rows.get(k, 0) for k in UNMET) / sum(rows.values())
