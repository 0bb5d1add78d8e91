"""Device time of the guidance gradient per guided call, ms: the program's
``fh.guide`` span (stage 5: the pullback through ``models/unet.py`` and
``ops/groupnorm.py``, or the covariance product; the guard and the
update), the card's time between its two timing events."""
import tracer


def read(ctx):
    return tracer.wall_ms_per_call("fh.guide")
