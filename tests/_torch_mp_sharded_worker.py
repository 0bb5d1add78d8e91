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
  CPU) on the rank's rows, forward and the gradients of a weighted sum;
  then ``decide`` on a flag the ranks disagree on, and on one they share.
* ``unet``: the spatially sharded UNet (``inputs["cfg"]``, the state dict
  ``inputs["sd"]``), forward and the vjp of a weighted sum, for each
  ``remat`` in ``inputs["remats"]``.
* ``freehunch``: ``samplers/edm.py::sample_loop`` with Free Hunch
  (``FreeHunch(model_group=)``) through the sharded UNet, the data group's rows of
  the batch: the trajectory, CG ``niter`` and the shape of the rank's
  ``diag``.
* ``smoke7a``: ``chip_smoke.py``'s phase 7a rank (``model_axis_rank``) on
  the CPU at 32 px, which writes ``rank<r>.pt`` itself.
* ``smoke7b``: the ``Evaluator`` on the CPU with ``inputs["args"]``, its
  guided calls and samples kept as phase 7b's rank probe keeps them
  (``chip_smoke.py::keeping_samples``); writes ``rank<r>.pt``.

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
    g = lambda t: sc.gather_d(t, mg)  # noqa: E731

    def state(c):
        return {"diag": g(c.diag), "Ut": coll.gather_replicated(c.Ut, 2, mg), "M": c.M,
                "k": c.k}

    # the states of tests/test_sharded_cov.py, one sample each
    out = {"jax_cases": [g(lr.matvec(sc.shard_state(lr.LowRank(*c), mg),
                                     v[:, sc.d_block(v.shape[1], mg)], red))
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
    x = coll.scatter(inp["x"], 1, mg).detach().requires_grad_(True)
    gamma = inp["gamma"].clone().requires_grad_(True)
    beta = inp["beta"].clone().requires_grad_(True)
    out = {}
    for silu in (True, False):
        y = groupnorm_silu_sharded(x, gamma, beta, 32, 1e-5, silu, mg)
        w = coll.scatter(inp["w"], 1, mg)
        gx, gg, gb = torch.autograd.grad((y * w).sum(), (x, gamma, beta))
        with torch.no_grad():
            out[silu] = {"y": coll.gather_replicated(y, 1, mg),
                         "gx": coll.gather_replicated(gx, 1, mg),
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


def unet(inp, remat, mg):
    from free_hunch_tpu_torch.models.unet import UNetConfig, UNetModel
    cfg = UNetConfig(**inp["cfg"], dtype=torch.float32, remat=remat)
    model = UNetModel(cfg, model_group=mg)
    model.load_state_dict(inp["sd"])
    return model.eval().requires_grad_(False)


def unet_mode(inp, mg) -> dict:
    out = {}
    for remat in inp["remats"]:
        model = unet(inp, remat, mg)
        with torch.no_grad():
            y = model(inp["x"], inp["t"])
        x = inp["x"].clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((model(x, inp["t"]) * inp["w"]).sum(), x)
        out[remat] = {"y": y, "gx": gx}
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
    if mode == "smoke7a":
        cs.model_axis_rank(__import__("pathlib").Path(outdir_), 0, dev="cpu",
                           setup=inp["setup"], batch=2, steps=3)
        return
    kept = {"d": [], "x0": [], "x": [], "niter": []}
    with cs.keeping_samples(kept):
        results = teval.Evaluator(tcfg.load_config(args=inp["args"]), device="cpu").run()
    torch.save(dict(results=results, samples={k: [t.numpy() for t in v]
                                              for k, v in kept.items()}),
               os.path.join(outdir_, f"rank{rank}.pt"))


try:
    dist.init(init_method=f"file://{store}", world_size=world, rank=rank, timeout=120)
    if mode in ("smoke7a", "smoke7b"):
        smoke_mode(outdir)
        sys.exit(0)
    mg = mesh.make_model_groups(mesh_shape)
    inputs = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    fn = {"cov": cov_mode, "gn": gn_mode, "unet": unet_mode, "freehunch": freehunch_mode}[mode]
    result = fn(inputs, mg)
    result["group"] = (mg.data_index, mg.data_size, mg.model_index, mg.model_size)
    torch.save(result, os.path.join(outdir, f"out_{rank}.pt"))
finally:
    dist.destroy()
print(f"rank {rank} done", flush=True)
