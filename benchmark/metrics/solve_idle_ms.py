"""The card's idle time per guided call under the program's ``fh.solve``
span, ms: the traced stretch's gaps between device operations whose middle
lies inside the span on the host (the CG's host reads and launches)."""
import tracer


def read(ctx):
    return tracer.idle_ms_per_call(ctx, "fh.solve")
