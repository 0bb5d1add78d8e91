"""The readings the correctness limits are set from, on the card.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--controls <k>] [--algebras tf32 bfloat16] [--faults <k>] [--out <file.json>]

For each seed, in one process: the seed's weights, one whole sampling run
of the program through the harness's boundary (its sampled steps copied
as in a benchmark run), and the numbers of ``compare.py`` for the
program: the lower readings. For the first ``--controls`` seeds the same
numbers for the control, computed from the same copied inputs: each stage
one precision below what the configuration states. The torso on the
program's own int8 path (``quant="int8"``: dynamic per-sample activation
scales, int8 products) for the denoiser and its pullback, or, where a
cell's ``control_torso`` says "fp8", the reference with its torso products'
operands rounded to float8 e4m3; the covariance update, the CG and the
covariance gradient as the reference computes them with TF32 matmuls, or
in bfloat16 where the cell's ``control_algebra`` says so (``--algebras``
reads both); the Heun update and the start in bfloat16. For the first
``--faults`` seeds also a CG that stops short, planted in the reference
put in the program's place (``cg_faults``). The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import compare  # noqa: E402
import harness  # noqa: E402
import inputs  # noqa: E402
import spec  # noqa: E402
import weights as weights_mod  # noqa: E402
from reference import freehunch as ref_fh  # noqa: E402


def control_torso(ctl: harness.Program, judge: compare.Judge, st, dev):
    """The control's denoiser at a sampled step's first call, from the
    program's copy of x_hat: (D, x) with x requiring its gradient in a vjp
    cell."""
    sigma = float(judge.sched["sigma_hat"][st.i])
    vjp = judge.gradient != "covariance"
    x = st.x_hat.to(dev).clone().requires_grad_(vjp)
    with torch.enable_grad() if vjp else torch.no_grad():
        if judge.control_torso == "fp8":
            D = torch.clamp(judge.fam.preclamp(judge.p, judge.arch, x, sigma,
                                               rounding=ref_fh.fp8), -1.0, 1.0)
        else:
            D, _ = ctl.precond(x, sigma)
    return D, x


def control_call(D, x, judge: compare.Judge, st, run, dev, low: str):
    """The control's outputs for a sampled step's first call from the
    program's copy of the state it found: the torso's ``D`` (its input
    ``x``), the algebra in ``low`` ("tf32" or "bfloat16")."""
    sigma = float(judge.sched["sigma_hat"][st.i])
    x_t = st.x_hat.to(dev)
    before = st.st0.before(dev)
    vjp = judge.gradient != "covariance"
    t = (lambda a: a.to(torch.bfloat16)) if low == "bfloat16" else (lambda a: a)
    with ref_fh.tf32(low == "tf32"):
        bf = ref_fh.Before(ref_fh.Cov(t(before.cov.diag), t(before.cov.Ut), t(before.cov.M),
                                      before.cov.k), before.prev_sigma, t(before.prev_x),
                           t(before.prev_mean), t(before.prev_u), before.step)
        cov = ref_fh.cov_update(bf, t(x_t), t(D.detach()), sigma, judge.basis)[0]
        sys_ = ref_fh.system(run.op, judge.basis, cov, t(D.detach()), t(run.y))
        start = bf.prev_u if before.step > 0 else sys_.b
        u, _ = ref_fh.cg(sys_, start, ref_fh.rtol_schedule(sigma))
        mat = ref_fh.mat_of(run.op, u).float()
        fb = ref_fh.fallback(judge.basis, cov, t(mat), sigma).float()
        cov = ref_fh.cov_to(cov, torch.float32)
    if vjp:
        (gv,) = torch.autograd.grad(D, x, mat, retain_graph=True)
        use_fb = ref_fh.guard_std(gv, sigma) > compare.GUARD
        g = torch.where(use_fb[:, None, None, None], fb, gv)
    else:
        g = fb
    upd = g * sigma ** 2
    upd = torch.where(torch.isfinite(upd), upd, torch.zeros_like(upd))
    return dict(D=D.detach(), cov=cov, u=u, x0=D.detach() + upd), mat


def cg_faults(judge: compare.Judge, st, run, dev) -> dict:
    """A CG that stops short, planted in the reference put in the program's
    place, on the program's own system of the call: tolerance x10, and
    half the iterations the reference's CG takes from the same start."""
    sigma = float(judge.sched["sigma_hat"][st.i])
    after = st.st1.before(dev)
    before = st.st0.before(dev)
    D, cov = after.prev_mean, after.cov
    rtol = ref_fh.rtol_schedule(sigma)
    u_ref, n = judge.cg_ref(run.op, before, cov, D, run.y, rtol)
    out = {}
    for name, kw in (("rtol_x10", dict(rtol=min(10 * rtol, 1.0))),
                     ("maxiter_half", dict(rtol=rtol, maxiter=max(1, n // 2)))):
        u, _ = judge.cg_ref(run.op, before, cov, D, run.y, **kw)
        k, v = judge.cg_number(run.op, cov, D, run.y, u, u_ref, sigma)
        out[name] = {k: v, "iterations_ref": n}
    return out


def _worst(into: dict, nums: dict):
    for k, v in nums.items():
        if isinstance(v, (int, float)):
            into[k] = max(into.get(k, 0.0), v)


def seed_readings(cell, seed, program, ctl, images, dev, with_control: bool,
                  algebras=None, faults=False) -> dict:
    """The program's numbers for one seed, and with ``with_control`` the
    control's in each of ``algebras`` (the cell's ``control_algebra`` by
    default; ``control`` is that one's) and with ``faults`` the planted CG
    faults'."""
    cfg, tr = cell["config"], cell["traffic"]
    fam = spec.reference(cfg)
    arch = fam.arch_of(cfg["model"])
    w = weights_mod.make(fam.param_shapes(arch), seed, dev, cfg["precision"])
    program.model.load_state_dict(w)
    if with_control and ctl is not None:
        ctl.model.load_state_dict(w)
    p32 = weights_mod.float32(w)
    del w
    judge = compare.Judge(fam, arch, p32, cfg["prior"], tr["steps"], cell["check"],
                          tr["mechanism"]["guidance_gradient"], seed, dev)
    algebras = tuple(algebras or (judge.control_algebra,))
    steps = harness.sampled_steps(seed, judge.sched, cell["check"]["bands"])
    caps = harness.Captures(steps, tr["steps"], tr["batch"], (3, arch.image_size,
                                                              arch.image_size),
                            program.capacity, dev.type == "cuda")
    run = inputs.Run(seed, 0, tr, images, dev, arch.image_size)
    boundary = harness.Boundary(program.mechanism(run), caps, dev)
    caps.begin(0)
    t0 = time.perf_counter()
    caps.end(program.sample(boundary, run))
    harness._sync(dev)
    run_s = time.perf_counter() - t0
    prog = {"start": harness.start_number(caps, run, judge, cfg["prior"], arch, dev)}
    ctls = {low: {} for low in algebras} if with_control else {}
    x_bf = (run.noise.bfloat16() * judge.sched["sigma0"]).float()
    for low in ctls:
        ctls[low]["start"] = harness.start_number(caps, run, judge, cfg["prior"], arch, dev,
                                                  x0=x_bf)
    vjp = judge.gradient != "covariance"
    per_step, planted = {}, {}
    for st in caps.whole():
        i = st.i
        outs = {}
        if with_control:
            D, x = control_torso(ctl, judge, st, dev)
            outs = {low: control_call(D, x, judge, st, run, dev, low) for low in algebras}
        extra = [(mat_c, c_out["D"]) for c_out, mat_c in outs.values()] if vjp else []
        n, pre, pulls = harness.judge_step(judge, st, run, dev, extra)
        n["k"] = int(st.st1.k.max())
        per_step[i] = {"program": n}
        _worst(prog, n)
        if faults:
            per_step[i]["faults"] = cg_faults(judge, st, run, dev)
            for name, f in per_step[i]["faults"].items():
                _worst(planted.setdefault(name, {}), f)
        sigma = float(judge.sched["sigma_hat"][i])
        x_t = st.x_hat.to(dev)
        heun = bool(judge.sched["use_heun"][i])
        args = (x_t, st.d1.to(dev), st.x_prime.to(dev) if heun else None,
                st.d2.to(dev) if heun else None)
        for j, (low, (c_out, _)) in enumerate(outs.items()):
            c = judge.call(x_t, sigma, st.st0.before(dev), run.y, run.op,
                           dict(c_out, pre_ref=pre, vjp_ref=pulls[j] if vjp else None))
            pred, _ = ref_fh.heun(*args, judge.sched, i, dtype=torch.bfloat16)
            _, nxt = ref_fh.heun(args[0], args[1], pred, args[3], judge.sched, i,
                                 dtype=torch.bfloat16)
            c["heun"] = judge.heun(i, args[0], args[1], pred.float() if heun else None,
                                   args[3], nxt.float())
            per_step[i][f"control_{low}"] = c
            _worst(ctls[low], c)
    return dict(seed=seed, steps=steps, run_s=run_s, program=prog,
                control=ctls.get(judge.control_algebra) or None, controls=ctls or None,
                faults=planted or None, per_step=per_step)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--algebras", nargs="+", default=None,
                   help="the control's algebras (tf32, bfloat16); default the cell's")
    p.add_argument("--faults", type=int, default=0,
                   help="seeds (the first ones) that also read the planted CG faults")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    cell = spec.cell(args.workload)
    cfg = cell["config"]
    fam = spec.reference(cfg)
    images = inputs.bundled_images(spec.ROOT / ".bench_cache" / "data")
    w = weights_mod.make(fam.param_shapes(fam.arch_of(cfg["model"])), args.seeds[0], dev,
                         cfg["precision"])
    program = harness.Program(cell, w, dev)
    ctl = harness.Program(cell, w, dev, quant="int8") \
        if args.controls and cell["check"]["control_torso"] == "int8" else None
    del w
    out = []
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = seed_readings(cell, seed, program, ctl, images, dev, j < args.controls,
                          args.algebras, j < args.faults)
        r["wall_s"] = time.perf_counter() - t0
        out.append(r)
        print(json.dumps(r), flush=True)
    sides = [("program", [r["program"] for r in out])]
    for r in out:
        for low, nums in (r["controls"] or {}).items():
            sides.append((f"control_{low}", [nums]))
        for name, nums in (r["faults"] or {}).items():
            sides.append((f"fault_{name}", [nums]))
    merged = {}
    for side, rows in sides:
        merged.setdefault(side, []).extend(rows)
    for side, rows in merged.items():
        keys = sorted({k for x in rows for k in x})
        print(json.dumps({side: {k: [min(x[k] for x in rows if k in x),
                                     max(x[k] for x in rows if k in x)] for k in keys}}),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
