"""One rank of a CPU gloo world for the port's model-axis tests (not a
pytest module). It imports the port only, never JAX.

    python tests/_torch_mp_sharded_worker.py <mode> <rank> <world> <store> <dir> <mesh>

The ranks meet through a ``file://`` store at ``<store>``, split into model
groups by ``<mesh>`` (``data:N,model:M``), read their inputs from
``<dir>/inputs.pt`` (written by the test, the same on every rank) and
write ``<dir>/out_<rank>.pt``. Every vector a rank holds a part of is
gathered whole before it is written. ``mode``:

* ``cov``: the d-sharded low-rank algebra (``parallel/sharded_cov.py``,
  every ``reduce``-taking function of ``ops/lowrank.py`` and
  ``guidance/covariance.py``) on the rank's block of the inputs' state.
* ``gn``: ``groupnorm_silu_sharded`` (the plain sharded version on the
  CPU) on the rank's rows (``split_sizes``: uneven where the model size
  does not divide them), forward and the gradients of a weighted sum;
  then ``decide`` on a flag the ranks disagree on, and on one they share.
* ``unet``: the spatially sharded UNet (``inputs["cfg"]``, the state dict
  ``inputs["sd"]``), forward and the vjp of a weighted sum, for each
  ``remat`` in ``inputs["remats"]`` and each int8 torso in
  ``inputs["quants"]`` (on ``inputs["xt"][quant]``, (x, t), where given).
* ``int8``: the int8 layers and K2's plain twin on the rank's rows.
* ``freehunch``: ``samplers/edm.py::sample_loop`` with Free Hunch
  (``FreeHunch(model_group=)``) through the sharded UNet, the data group's rows of
  the batch: the trajectory, CG ``niter`` and the shape of the rank's
  ``diag``.
* ``smoke7a``, ``smoke7c``, ``smoke7d``: ``chip_smoke.py``'s phase 7a, 7c
  or 7d rank (``model_axis_rank``, ``int8_axis_rank``,
  ``ragged_axis_rank``) on the CPU at 32 px, which writes its own output.
* ``smoke7b``: the ``Evaluator`` (the ``DDNMEvaluator`` for DDNM+: phase
  7e) on the CPU with ``inputs["args"]``, its guided calls and samples kept
  as phase 7b's rank probe keeps them (``chip_smoke.py::keeping_samples``);
  writes ``rank<r>.pt``.

In the ``smoke`` modes ``inputs["wrong"] == "no_halo"`` drops the halo
exchange (``chip_smoke.py::no_halo``).
"""
import os
import sys

mode, rank, world, store, outdir, mesh_shape = (sys.argv[1], int(sys.argv[2]),
                                                int(sys.argv[3]), sys.argv[4], sys.argv[5],
                                                sys.argv[6])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from free_hunch_tpu_torch.parallel import collectives as coll  # noqa: E402
from free_hunch_tpu_torch.parallel import dist, mesh  # noqa: E402


def cov_mode(inp, mg) -> dict:
    from free_hunch_tpu_torch.guidance import covariance as cv
    from free_hunch_tpu_torch.ops import lowrank as lr
    from free_hunch_tpu_torch.parallel import sharded_cov as sc

    whole = lr.LowRank(*inp["cov"])
    cov = sc.shard_state(whole, mg)
    red = sc.model_reduce(mg)
    blk = sc.d_block(whole.diag.shape[-1], mg)
    part = {k: inp[k][:, blk] for k in ("v", "a", "b", "x", "x2", "m", "m2")}
    d = whole.diag.shape[-1]
    g = lambda t: sc.gather_d(t, mg, d)  # noqa: E731

    def state(c):
        return {"diag": g(c.diag), "Ut": sc.gather_d(c.Ut, mg, d), "M": c.M, "k": c.k}

    # the states of tests/test_sharded_cov.py, one sample each
    out = {"jax_cases": [sc.gather_d(lr.matvec(sc.shard_state(lr.LowRank(*c), mg),
                                               v[:, sc.d_block(v.shape[1], mg)], red),
                                     mg, v.shape[1])
                         for c, v in inp["jax_cases"]]}
    out.update({"block": torch.tensor([blk.start, blk.stop]), "diag_cols": cov.diag.shape[-1],
           "matvec": g(lr.matvec(cov, part["v"], red)),
           "inverse": state(lr.inverse(cov, red)),
           "compress": state(lr.compress(cov, 3, red)),
           "append": state(lr.append_pair(cov, part["a"], inp["wa"], part["b"], inp["wb"],
                                          red)),
           "time_update": state(cv.time_update(cov, 6.0, 2.5, red))})
    for name, fn in (("transport", cv.transport_score),
                     ("transport2", cv.transport_score_two_inverse)):
        mean, score = fn(cov, None, 6.0, 2.5, part["x"], part["v"], red)
        out[name] = (g(mean), g(score))
    out["space_update"] = state(cv.space_update(cov, 2.5, part["x"], part["x2"], part["m"],
                                                part["m2"], reduce=red))
    return out


def gn_mode(inp, mg) -> dict:
    from free_hunch_tpu_torch.ops.groupnorm import groupnorm_silu_sharded
    rows = mesh.split_sizes(inp["x"].shape[1], mg.model_size)
    x = coll.scatter(inp["x"], 1, mg, rows).detach().requires_grad_(True)
    gamma = inp["gamma"].clone().requires_grad_(True)
    beta = inp["beta"].clone().requires_grad_(True)
    out = {}
    for silu in (True, False):
        y = groupnorm_silu_sharded(x, gamma, beta, 32, 1e-5, silu, mg)
        w = coll.scatter(inp["w"], 1, mg, rows)
        gx, gg, gb = torch.autograd.grad((y * w).sum(), (x, gamma, beta))
        with torch.no_grad():
            out[silu] = {"y": coll.gather_replicated(y, 1, mg, rows),
                         "gx": coll.gather_replicated(gx, 1, mg, rows),
                         # the affine's gradient is each rank's part: summed here
                         "gg": coll.all_reduce(gg, mg), "gb": coll.all_reduce(gb, mg)}
    # a host decision the ranks disagree on raises on every rank
    try:
        coll.decide(torch.tensor(mg.model_index == 0), mg)
        out["diverged_raises"] = False
    except RuntimeError:
        out["diverged_raises"] = True
    out["agreed"] = coll.decide(torch.tensor(True), mg)
    return out


def unet(inp, remat, mg, quant=None, fused=False):
    """The UNet of ``inputs["cfg"]`` and ``inputs["sd"]`` in f32, on the
    ``quant`` torso (``int8_static``: ``inputs["table"]``'s scale at every
    site)."""
    from free_hunch_tpu_torch.models.unet import UNetConfig, UNetModel
    from free_hunch_tpu_torch.ops.quant import _QuantSite
    cfg = UNetConfig(**inp["cfg"], dtype=torch.float32, remat=remat, quant=quant,
                     fused_gn_quant=fused)
    model = UNetModel(cfg, model_group=mg)
    model.load_state_dict(inp["sd"])
    if quant == "int8_static":
        for name, m in model.named_modules():
            if isinstance(m, _QuantSite):
                m.act_scale = torch.tensor(float(inp["table"][name]))
    return model.eval().requires_grad_(False)


def unet_mode(inp, mg) -> dict:
    """Forward and vjp for each ``remat`` in ``inputs["remats"]``, or with
    ``inputs["quants"]`` for each (quant, fused) torso (remat on)."""
    out = {}
    runs = [(r, None, False) for r in inp.get("remats", ())] + \
        [(True, q, f) for q, f in inp.get("quants", ())]
    for remat, quant, fused in runs:
        model = unet(inp, remat, mg, quant, fused)
        xin, tin = inp.get("xt", {}).get(quant, (inp["x"], inp["t"]))
        with torch.no_grad():
            y = model(xin, tin)
        key = remat if quant is None else (quant, fused)
        out[key] = {"y": y}
        if quant == "int8_calib":  # each site's abs-max of the forward
            from free_hunch_tpu_torch.ops.quant import _QuantSite
            out[key]["amax"] = {n: float(m.amax) for n, m in model.named_modules()
                                if isinstance(m, _QuantSite)}
        x = xin.clone().requires_grad_(True)
        (out[key]["gx"],) = torch.autograd.grad((model(x, tin) * inp["w"]).sum(), x)
    return out


def int8_mode(inp, mg) -> dict:
    """The int8 layers on the rank's rows (``split_sizes`` of the height),
    each output and the gradient of a weighted sum gathered whole:
    ``_quantize_act`` (codes and scale), ``QuantConv`` 3x3 (dynamic and
    static) and 1x1, ``QuantDense`` over the rank's positions, K2's plain
    twin ``gn_silu_quant_sharded_plain`` and the fused route
    ``QuantConv(x, gn=...)``."""
    from free_hunch_tpu_torch.ops import gn_quant as gq
    from free_hunch_tpu_torch.ops.quant import QuantConv, QuantDense, _quantize_act
    x = inp["x"]                                          # (n, c, h, w)
    rows = mesh.split_sizes(x.shape[2], mg.model_size)
    mine = coll.scatter(x, 2, mg, rows)
    whole = lambda t, dim=2: coll.gather_replicated(t, dim, mg, rows)  # noqa: E731
    out = {}
    xq, scale = _quantize_act(mine.permute(0, 2, 3, 1), mg)
    out["act"] = (whole(xq, 1), scale)

    def pulled(module, name, gn=None, **kw):
        xs = mine.clone().requires_grad_(True)
        y = module(xs, **kw) if gn is None else module(xs, gn=gn, **kw)
        w = coll.scatter(inp["w_" + name], 2, mg, rows)
        (gx,) = torch.autograd.grad((y * w).sum(), xs)
        out[name] = (whole(y.detach()), whole(gx))

    for name, k, mode in (("conv3", 3, "dynamic"), ("conv3_static", 3, "static"),
                          ("conv1", 1, "dynamic")):
        m = QuantConv(x.shape[1], inp["cout"], k, mode=mode, dtype=torch.float32)
        m.load_state_dict(inp["sd_" + name])
        if mode == "static":
            m.act_scale = inp["static_scale"]
        pulled(m.requires_grad_(False), name, shard=(mg, rows))
    dense = QuantDense(x.shape[1], inp["cout"], dtype=torch.float32)
    dense.load_state_dict(inp["sd_dense"])
    dense.requires_grad_(False)
    n, c, _, wd = x.shape
    ys = mine.permute(0, 2, 3, 1).reshape(n, -1, c).clone().requires_grad_(True)
    yd = dense(ys, mg=mg)
    wdn = coll.scatter(inp["w_dense"], 1, mg, [r * wd for r in rows])
    (gd,) = torch.autograd.grad((yd * wdn).sum(), ys)
    sizes = [r * wd for r in rows]
    out["dense"] = (coll.gather_replicated(yd.detach(), 1, mg, sizes),
                    coll.gather_replicated(gd, 1, mg, sizes))
    g_nc, b_nc = inp["gamma_nc"], inp["beta_nc"]
    gxq, gscale = gq.gn_silu_quant_sharded_plain(mine.permute(0, 2, 3, 1).contiguous(), g_nc,
                                                 b_nc, 32, 1e-5, mg)
    out["gnq"] = (whole(gxq, 1), gscale)
    fused = QuantConv(x.shape[1], inp["cout"], 3, dtype=torch.float32)
    fused.load_state_dict(inp["sd_conv3"])
    pulled(fused.requires_grad_(False), "fused", gn=(g_nc, b_nc), shard=(mg, rows))
    return out


def freehunch_mode(inp, mg) -> dict:
    from free_hunch_tpu_torch.guidance import mechanisms as tmech
    from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond
    from free_hunch_tpu_torch.operators import get_operator
    from free_hunch_tpu_torch.samplers import edm

    res = inp["cfg"]["image_size"]
    pre = IDDPMLinearPrecond(unet(inp, False, mg), img_resolution=res, img_channels=3)
    op = get_operator(device="cpu", **inp["op"])
    mech = tmech.FreeHunch(forward_operator=op, model_group=mg, **inp["mech"])
    rows = slice(mg.data_index * inp["rows"], (mg.data_index + 1) * inp["rows"])
    cov = mech.init_state(inp["rows"], (3, res, res)).cov
    seen = {"diag": tuple(cov.diag.shape), "Ut": tuple(cov.Ut.shape)}
    x, traj, diag = edm.sample_loop(pre, mech, inp["noise"][rows], inp["y"][rows], inp["xs"],
                                    sigma0_scaled=inp["s0"], return_trajectory=True,
                                    collect_diagnostics=True)
    return {"traj": traj, "cg_niter": diag["cg_niter"], "rows": (rows.start, rows.stop),
            **seen}


def smoke_mode(outdir_):
    """chip_smoke.py's phase 7a rank (``inputs["setup"]``, batch 2, 3 Heun
    steps) or 7b's Evaluator, on the CPU at 32 px."""
    import chip_smoke as cs
    from free_hunch_tpu_torch import config as tcfg
    from free_hunch_tpu_torch import eval as teval
    inp = torch.load(os.path.join(outdir_, "inputs.pt"), weights_only=False)
    if inp.get("wrong") == "no_halo":
        coll.halo_rows = cs.no_halo
    path = __import__("pathlib").Path(outdir_)
    if mode == "smoke7a":
        cs.model_axis_rank(path, 0, dev="cpu", setup=inp["setup"], batch=2, steps=3)
        return
    if mode == "smoke7c":
        cs.int8_axis_rank(path, 0, dev="cpu", setup=inp["setup"], batch=2, steps=3)
        return
    if mode == "smoke7d":
        cs.ragged_axis_rank(path, 0, dev="cpu", setup=inp["setup"], batch=2,
                            dtype=torch.float32)
        return
    from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator
    kept = {"d": [], "x0": [], "x": [], "niter": []}
    opts = tcfg.load_config(args=inp["args"])
    cls = DDNMEvaluator if opts.get("conditioning_mechanism") == "ddnm" else teval.Evaluator
    with cs.keeping_samples(kept):
        results = cls(opts, device="cpu").run()
    torch.save(dict(results=results, samples={k: [t.numpy() for t in v]
                                              for k, v in kept.items()}),
               os.path.join(outdir_, f"rank{rank}.pt"))


try:
    dist.init(init_method=f"file://{store}", world_size=world, rank=rank, timeout=120)
    if mode.startswith("smoke"):
        smoke_mode(outdir)
        sys.exit(0)
    mg = mesh.make_model_groups(mesh_shape)
    inputs = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    fn = {"cov": cov_mode, "gn": gn_mode, "unet": unet_mode, "freehunch": freehunch_mode,
          "int8": int8_mode}[mode]
    result = fn(inputs, mg)
    result["group"] = (mg.data_index, mg.data_size, mg.model_index, mg.model_size)
    torch.save(result, os.path.join(outdir, f"out_{rank}.pt"))
finally:
    dist.destroy()
print(f"rank {rank} done", flush=True)
