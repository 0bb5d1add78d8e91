"""Host reads of the card by the CG loop's stopping decisions per guided
call over the window: the program's own count (``cg_host_syncs`` of the
state each call returns; ``ops/cg.py``)."""


def read(ctx):
    return ctx["host_syncs"] / ctx["calls"] if ctx.get("calls") else None
