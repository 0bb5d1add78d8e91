"""Device time of Free Hunch's covariance update per guided call, ms: the
program's ``fh.cov_update`` span (stages 1-3: time update, transport, the
BFGS pair and the compress; ``guidance/covariance.py``, ``ops/lowrank.py``,
``ops/dct.py``), the card's time between its two timing events."""
import tracer


def read(ctx):
    return tracer.wall_ms_per_call("fh.cov_update")
