"""Device time of the denoiser's forward per guided call, ms: the kernels
launched under the harness's span around the denoise callable
(``models/precond.py`` -> ``models/unet.py``) in the traced stretch."""


def read(ctx):
    tr = ctx.get("trace")
    spans = tr.spans.get("bench.denoise", []) if tr is not None else []
    total = sum(spans)
    return total / len(spans) * 1e3 if spans and total > 0 else None
