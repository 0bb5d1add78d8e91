"""Reads of the card by the host per guided call over the traced stretch:
the program's ``host_reads`` counter, every ``host.read`` (the CG's
stopping tests, ``x_changed``, the compress check of ``ops/lowrank.py``)."""
import tracer


def read(ctx):
    snap = tracer.snapshot()
    n = tracer.calls(snap)
    return snap["counts"].get("host_reads", 0) / n if n else None
