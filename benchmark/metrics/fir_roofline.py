"""FIR resampling (``ops/fir.py``): the least time its calls and their
pullbacks could take, each call's x read and y written once and each
pullback's dy read and dx written once, at the torso's type, over the
card's HBM bandwidth, as a share of the device time of the program's
``fir.resample`` and ``fir.resample_backward`` spans in the traced
stretch (each span's wall between its two timing events). The calls'
shapes are the family's ``fir_inputs`` (one forward's); the spans' counts
say how many forwards' and pullbacks' worth ran (a remat'd block's calls
run again in the pullback). None where the stretch holds no FIR call, or
the family has no FIR."""
import flops
import spec
import tracer
import weights


def read(ctx):
    snap = tracer.snapshot()
    cfg = ctx["cell"]["config"]
    fam = spec.reference(cfg)
    if not snap or not hasattr(fam, "fir_inputs"):
        return None
    calls, walls = snap["calls"], snap["device_s"]
    fwd, bwd = calls.get("fir.resample", 0), calls.get("fir.resample_backward", 0)
    t = walls.get("fir.resample", 0.0) + walls.get("fir.resample_backward", 0.0)
    if not fwd or t <= 0:
        return None
    shapes = fam.fir_inputs(fam.arch_of(cfg["model"]))
    size = weights.dtype(cfg["precision"]["torso"]).itemsize
    batch = ctx["cell"]["traffic"]["batch"]
    per_forward = 0
    for c, h, w, kind in shapes:
        ho, wo = (2 * h, 2 * w) if kind == "up" else (h // 2, w // 2)
        per_forward += batch * c * (h * w + ho * wo) * size
    moved = per_forward * (fwd + bwd) / len(shapes)
    return 100.0 * moved / flops.HBM_BYTES_PER_S / t
