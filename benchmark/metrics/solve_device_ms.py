"""Device time of Free Hunch's solve per guided call, ms: the program's
``fh.solve`` span (stage 4: the Gram trace, then ``choose_solver`` and its
CG; ``guidance/solvers.py``, ``ops/cg.py``), the card's time between its
two timing events, the CG's host reads included."""
import tracer


def read(ctx):
    return tracer.wall_ms_per_call("fh.solve")
