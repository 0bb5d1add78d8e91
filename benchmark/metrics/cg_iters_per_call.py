"""CG iterations per guided call over the window: the program's own count
(``cg_niter`` of the state each call returns; ``guidance/solvers.py``,
``ops/cg.py``)."""


def read(ctx):
    return ctx["cg_iters"] / ctx["calls"] if ctx.get("calls") else None
