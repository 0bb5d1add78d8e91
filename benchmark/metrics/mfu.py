"""The whole guided step's share of the card's peak: the model FLOPs the
window completed (the frozen counts: the denoiser family's forward and, in
a vjp cell, its input pullback (``reference/<family>.py``), and
``benchmark/flops.py``'s covariance algebra with the CG's products for the
iterations these inputs took) over the window's seconds, each precision
against its peak (``flops.PEAK_FLOPS``: bfloat16 989, float32 67 TFLOP/s;
an int8 torso's products 1,979 TOP/s)."""
import flops
import spec


def read(ctx):
    cell = ctx["cell"]
    if not ctx.get("calls"):
        return None
    cfg, tr = cell["config"], cell["traffic"]
    fam = spec.reference(cfg)
    arch = fam.arch_of(cfg["model"])
    torso = flops.torso_products(cfg["precision"])
    per_call = dict(fam.forward_flops(arch, torso, tr["batch"]))
    if tr["mechanism"]["guidance_gradient"] != "covariance":
        for k, v in fam.input_backward_flops(arch, torso, tr["batch"]).items():
            per_call[k] = per_call.get(k, 0) + v
    alg = flops.Algebra(tr["batch"], arch.image_size, ctx["capacity"],
                        cfg["prior"]["name"].startswith("dct"))
    total = {k: v * ctx["calls"] for k, v in per_call.items()}
    total["float32"] = total.get("float32", 0) + alg.flops(ctx["calls"], ctx["cg_iters"])
    busy = sum(v / flops.PEAK_FLOPS[k] for k, v in total.items())
    return 100.0 * busy / ctx["window_s"]
