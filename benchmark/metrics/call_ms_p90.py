"""The 90th percentile of a guided call's wall time, ms: the harness's span
around each call of the mechanism, the card synchronised on both sides,
over the traced run's window (``samplers/edm.py::sample_loop`` ->
``guidance/mechanisms.py``)."""
import numpy as np


def read(ctx):
    calls = ctx.get("call_s") or []
    return float(np.percentile(np.asarray(calls) * 1e3, 90)) if calls else None
