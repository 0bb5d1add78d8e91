"""The whole guided step's share of the card's peak: the model FLOPs the
window completed (the frozen count of ``benchmark/flops.py``: the
denoiser's forward, its input pullback in a vjp cell, the covariance
algebra, and the CG's products for the iterations these inputs took) over
the window's seconds, each precision against its peak (``flops.PEAK_FLOPS``:
bfloat16 989, float32 67 TFLOP/s; an int8 torso's products 1,979 TOP/s)."""
import flops
from reference import unet as ref_unet


def read(ctx):
    cell = ctx["cell"]
    if not ctx.get("calls"):
        return None
    cfg, tr = cell["config"], cell["traffic"]
    arch = ref_unet.arch_of(cfg["model"])
    torso = flops.torso_products(cfg["precision"])
    per_call = dict(flops.forward(arch, torso, tr["batch"]))
    if tr["mechanism"]["guidance_gradient"] != "covariance":
        for k, v in flops.input_backward(arch, torso, tr["batch"]).items():
            per_call[k] = per_call.get(k, 0) + v
    alg = flops.Algebra(tr["batch"], arch.image_size, ctx["capacity"],
                        cfg["prior"]["name"].startswith("dct"))
    total = {k: v * ctx["calls"] for k, v in per_call.items()}
    total["float32"] = total.get("float32", 0) + alg.flops(ctx["calls"], ctx["cg_iters"])
    busy = sum(v / flops.PEAK_FLOPS[k] for k, v in total.items())
    return 100.0 * busy / ctx["window_s"]
