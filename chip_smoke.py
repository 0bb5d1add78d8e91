#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``free_hunch_tpu_torch``) on one card.

    python3 chip_smoke.py                      # batch 8, 30 Heun steps
    python3 chip_smoke.py --batch 2 --steps 3  # a shorter rehearsal

Phases, in order; any failure raises and exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, the TF32
   flags the port sets, and the build of every kernel from ``csrc/``.
2. kernels: every hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main path gives it, with times, the bound
   and the library call of the same function (timed only, never used).
3. reference: a 32 px Free Hunch slice on the card (kernels) against the
   same slice on the CPU (plain versions), same weights and inputs.
4. slice: the ``bench.py`` protocol in the port. Guided 256x256
   gaussian-blur deblurring with Free Hunch (``online_covariance``,
   DCT-diagonal prior, tailored CG recycling the previous stage's solution,
   vjp guidance gradient) through the full-width, full-depth 256 px ADM
   UNet with seeded random weights, bf16 torso with remat, EDM Heun. The
   kernels' launch counters are zeroed just before the first run and read
   just after it. One more run under ``torch.profiler`` gives the device
   time by kernel family and the device's idle share.

The last two lines of standard output are the ``kernels`` JSON object and
the ``device`` JSON object. Without a CUDA card the script prints no result
and exits with code 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import free_hunch_tpu_torch as fht
from free_hunch_tpu_torch.guidance import choose_conditioning_mechanism
from free_hunch_tpu_torch.models import loading
from free_hunch_tpu_torch.models.unet import GroupNorm32, ResBlock, create_model
from free_hunch_tpu_torch.operators import get_operator
from free_hunch_tpu_torch.ops import _nvcc
from free_hunch_tpu_torch.ops import groupnorm as gn
from free_hunch_tpu_torch.samplers import edm

ROOT = Path(__file__).resolve().parent
SETUP_256 = ROOT / "models" / "256x256_diffusion_uncond_setup.txt"
CKPT_256 = ROOT / "models" / "256x256_diffusion_uncond.pt"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# GroupNorm+SiLU arithmetic per element: Welford update 5, normalise+affine 4,
# SiLU (exp, add, divide, multiply) 4
GN_FLOPS_PER_ELEM = {True: 13, False: 9}
GN_ENTRY = dict(name="groupnorm_silu", route="cuda",
                source="free_hunch_tpu_torch/csrc/groupnorm.cu",
                replaces="free_hunch_tpu/ops/pallas_groupnorm.py:109")


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 1: card ----------------------------------------------------------

def card_facts() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    say(smi)
    fht.use_full_f32()
    say(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    say(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    report = _nvcc.build("groupnorm")
    if report is None:
        say("groupnorm kernel: library already built from this source")
    else:
        say(f"groupnorm kernel built in {report['seconds']:.2f} s")
        for line in report["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {line.strip()}")
    return smi


# -- phase 2: kernels against their plain versions ---------------------------

def gn_shapes_of_forward(model, batch: int, res: int, dev) -> Counter:
    """(NHWC shape, dtype, apply_silu) -> calls, over one no-grad forward;
    also checks that the forward launches the kernel once per GroupNorm."""
    seen = Counter()

    def hook(mod, inputs):
        x = inputs[0]
        seen[(tuple(x.permute(0, 2, 3, 1).shape), x.dtype, mod.apply_silu)] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm32)]
    before = gn.launches
    with torch.no_grad():
        model(torch.zeros((batch, 3, res, res), device=dev),
              torch.full((batch,), 500.0, device=dev))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    n_norms = sum(isinstance(m, GroupNorm32) for m in model.modules())
    calls = sum(seen.values())
    if not calls == n_norms == gn.launches - before:
        raise AssertionError(f"one forward: {calls} GroupNorm calls, {n_norms} "
                             f"modules, {gn.launches - before} kernel launches")
    say(f"one UNet forward at batch {batch}: {calls} GroupNorm calls, "
        f"{len(seen)} distinct shapes, {calls} kernel launches")
    return seen


def check_gn(shape, dtype, silu, gen, reps=20):
    """Kernel vs plain on one shape; returns the measurements."""
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    y = gn.groupnorm_silu_cuda(x, g, b, 32, 1e-5, silu)
    want = gn.groupnorm_silu_plain(x, g, b, 32, 1e-5, silu)
    torch.cuda.synchronize()
    err = float((y.float() - want.float()).abs().max())
    if dtype == torch.float32:
        # same f32 formula, other summation order
        tol = "rtol=atol=1e-5"
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    else:
        # f32 arithmetic rounded once to bf16 in both: two bf16 ulps of the
        # output magnitude
        mag = float(want.float().abs().max())
        limit = 2 * 2.0 ** (np.floor(np.log2(mag)) - 7)
        tol = f"max_abs<={limit:g} (2 bf16 ulps of {mag:.3g})"
        if not err <= limit:
            raise AssertionError(f"groupnorm kernel {shape} {dtype}: max abs err "
                                 f"{err} > {limit}")
    xp = x.permute(0, 3, 1, 2)
    gl, bl = g.to(dtype), b.to(dtype)
    if silu:
        lib = lambda: F.silu(F.group_norm(xp, 32, gl, bl, 1e-5))  # noqa: E731
    else:
        lib = lambda: F.group_norm(xp, 32, gl, bl, 1e-5)  # noqa: E731
    ms = time_ms(lambda: gn.groupnorm_silu_cuda(x, g, b, 32, 1e-5, silu), reps)
    plain_ms = time_ms(lambda: gn.groupnorm_silu_plain(x, g, b, 32, 1e-5, silu),
                       max(2, reps // 4))
    library_ms = time_ms(lib, reps)
    # the guidance vjp's pullback through this call: the autograd.Function's
    # backward, which recomputes the plain version (there is no backward kernel)
    xg = x.detach().requires_grad_(True)
    yg = gn.groupnorm_silu(xg, g, b, 32, 1e-5, silu)
    ct = torch.ones_like(yg)
    bwd_ms = time_ms(lambda: torch.autograd.grad(yg, xg, ct, retain_graph=True),
                     max(2, reps // 4))
    # each input read once, the output written once
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    flops = GN_FLOPS_PER_ELEM[silu] * x.numel()
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return dict(shape=shape, dtype=str(dtype).replace("torch.", ""), silu=silu,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bwd_ms=bwd_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_phase(forward_shapes: Counter) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    say("groupnorm_silu kernel vs plain (times in ms per call):")
    named = [("in_norm", (2, 256, 256, 256), torch.bfloat16, True),
             ("decoder_concat", (2, 256, 256, 512), torch.bfloat16, True),
             ("out_norm_f32", (2, 256, 256, 256), torch.float32, True),
             ("attn_norm_8x8", (2, 8, 8, 1024), torch.bfloat16, False)]
    for label, shape, dtype, silu in named:
        r = check_gn(shape, dtype, silu, gen)
        say(f"  {label:15s} {r['shape']} {r['dtype']} silu={silu}: err "
            f"{r['max_abs_err']:.3g} ({r['tol']}) kernel {r['ms']:.4f} plain "
            f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    # the entry of the kernels line: all GroupNorms of one main-path forward
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bwd_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    err = 0.0
    say("  one main-path UNet forward, per distinct shape (calls x ms):")
    for (shape, dtype, silu), calls in sorted(forward_shapes.items(),
                                              key=lambda kv: -np.prod(kv[0][0])):
        r = check_gn(shape, dtype, silu, gen)
        err = max(err, r["max_abs_err"])
        for k in tot:
            tot[k] += calls * r[k]
        say(f"    {calls:3d} x {r['shape']} {r['dtype']} silu={silu}: err "
            f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} plain {r['plain_ms']:.4f} "
            f"library {r['library_ms']:.4f} bound {r['bound_ms']:.4f} backward "
            f"{r['bwd_ms']:.4f}")
    n = sum(forward_shapes.values())
    bound_by = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    bound_ms = max(tot["bytes_ms"], tot["ops_ms"])
    say(f"  sum over the {n} calls of one forward: kernel {tot['ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: {tot['bytes_ms']:.3f} ms of bytes at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s, {tot['ops_ms']:.3f} ms of f32 operations); "
        f"their backward in the guidance vjp (plain autograd) {tot['bwd_ms']:.3f} ms")
    return dict(GN_ENTRY, max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=tot["library_ms"])


# -- phases 3 and 4: the slice -----------------------------------------------

class Recorder:
    """Pass-through guidance mechanism that keeps the last state."""

    def __init__(self, mech):
        self.mech, self.state = mech, None

    def init_state(self, batch, img_shape):
        return self.mech.init_state(batch, img_shape)

    def __call__(self, denoise, x_t, y, sigma, state):
        x0, self.state = self.mech(denoise, x_t, y, sigma, state)
        return x0, self.state


def free_hunch(op, res: int, cap: int, prior: str):
    """The bench.py mechanism configuration."""
    return choose_conditioning_mechanism("online_covariance")(
        cond_scaling=1.0, forward_operator=op, clip_x0_mean=False,
        image_base_covariance=prior, init_denoiser_variance=1.0,
        init_noise_variance=80.0**2, data_dim=3 * res * res, cov_capacity=cap,
        solver_type="customcuda", max_rtol=1.0, cg_maxiter=5000, cg_coords="pixel",
        cg_warm_start="prev", guidance_gradient="vjp", guidance_vjp_below=2.0)


def schedule(precond, steps: int):
    return edm.prepare_schedule(
        round_sigma=precond.round_sigma, net_sigma_min=precond.sigma_min,
        net_sigma_max=precond.sigma_max, num_steps=steps, solver="heun",
        discretization="edm", schedule="linear", scaling="none")


def reference_phase(seed: int):
    """32 px slice, f32 UNet, 3 Heun steps: card (kernels) vs CPU (plain)."""
    res, batch, steps = 32, 2, 3
    tiny = dict(image_size=res, num_channels=32, num_res_blocks=1, channel_mult="1,2",
                attention_resolutions="8", num_head_channels=16, dtype=torch.float32)
    cpu_model = loading.random_init_(create_model(**tiny), seed=seed)
    with torch.device("cuda"):
        gpu_model = create_model(**tiny)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(batch, 3, res, res)).astype(np.float32)
    y = rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32)
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        model.eval().requires_grad_(False)
        precond = loading.wrap_precond(model, {"image_size": res})
        xs, s0 = schedule(precond, steps)
        op = get_operator("gaussian_blur", in_shape=(1, 3, res, res), sigma_s=0.1,
                          device=dev)
        mech = free_hunch(op, res, edm.required_cov_capacity(xs), "dct_diagonal_noinfo")
        before = gn.launches
        x, traj, diag = edm.sample_loop(
            precond, mech, torch.as_tensor(noise, device=dev),
            torch.as_tensor(y, device=dev), xs, sigma0_scaled=s0,
            return_trajectory=True, collect_diagnostics=True)
        out[dev] = (traj.cpu().numpy(), diag["cg_niter"].numpy(), gn.launches - before)
    (tc, nc, lc), (tg, ng, lg) = out["cpu"], out["cuda"]
    if lc != 0 or lg == 0:
        raise AssertionError(f"reference phase: {lc} launches on the CPU run, "
                             f"{lg} on the card run")
    # f32 UNet, FFT and CG on two devices round differently, and a CG stopped
    # at rtol moves by ~rtol: each step before the last is held to 1e-3 of
    # its own max |x| (observed 3.36e-4 of 14.6 and 9.92e-3 of 613 on an
    # H100 80GB HBM3 at 700 W); the last one, whose output lies in [-1, 1],
    # to 4e-3 absolute (observed 9.46e-4 there)
    limit = 1e-3 * np.abs(tc).reshape(steps, -1).max(axis=1)
    limit[-1] = 4e-3
    err = np.abs(tg - tc).reshape(steps, -1).max(axis=1)
    say(f"reference 32 px slice, card vs CPU: per-step max |dx| {err.tolist()} "
        f"(limits {limit.tolist()}), CG niter card {ng.tolist()} "
        f"cpu {nc.tolist()}, card kernel launches {lg}")
    if not (np.isfinite(tg).all() and (err <= limit).all() and (ng == nc).all()):
        raise AssertionError("reference phase: card and CPU slices disagree")


KERNEL_FAMILIES = (("groupnorm_silu (csrc/groupnorm.cu)", ("gn_stats", "gn_finalize",
                                                            "gn_apply")),
                   ("cuFFT", ("fft",)),
                   ("convolutions and matmuls (cuDNN, cuBLAS)",
                    ("gemm", "xmma", "conv", "cutlass", "cudnn", "implicit")),
                   ("softmax", ("softmax",)))
BWD_RANGE = "groupnorm_silu_backward"   # the profiler range in ops/groupnorm.py


def device_breakdown(run_once):
    """One more sampling run under ``torch.profiler`` (device activity only):
    device time by kernel family, and the device's idle share of the run's
    wall time. Slower than an unprofiled run; its wall time is not the
    slice's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fams, kernels = Counter(), Counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key == BWD_RANGE:
            continue
        name = e.key.lower()
        fam = next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)),
                   "other (elementwise, reductions, copies)")
        fams[fam] += e.self_device_time_total
        kernels[e.key] += e.self_device_time_total
    busy = sum(fams.values())
    if busy <= 0:
        say("  profiled run: the profiler saw no device time; breakdown not measured")
        return
    say(f"  profiled run: wall {wall_us / 1e6:.3f} s, device busy {busy / 1e6:.3f} s, "
        f"idle share {1 - busy / wall_us:.3f}")
    for fam, us in fams.most_common():
        say(f"    {fam}: {us / 1e6:.3f} s ({us / busy:.3f} of device time)")
    say("  the 8 kernels with the most device time:")
    for name, us in kernels.most_common(8):
        say(f"    {us / 1e6:.3f} s  {name[:110]}")
    return busy


def backward_share(guided_call, calls_per_run: int, run_busy_us: float):
    """One guided call (forward, vjp, covariance and CG) under
    ``torch.profiler`` with host and device activity: the device time of
    the kernels launched inside the ``groupnorm_silu_backward`` ranges, as a
    share of the call's device time and, times the calls of a run, of the
    profiled run's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        guided_call()
        torch.cuda.synchronize()
    events = prof.events()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and e.name != BWD_RANGE)
    ranges = [e for e in events
              if e.device_type == DeviceType.CPU and e.name == BWD_RANGE]
    bwd = sum(e.device_time_total for e in ranges)
    if busy <= 0 or not ranges:
        raise AssertionError(f"backward attribution: {len(ranges)} backward ranges, "
                             f"{busy} us of device time in the trace")
    say(f"  one guided call traced: device {busy / 1e3:.3f} ms, of which "
        f"{len(ranges)} groupnorm_silu_backward ranges {bwd / 1e3:.3f} ms "
        f"({bwd / busy:.3f}); x {calls_per_run} calls = {bwd * calls_per_run / 1e6:.3f}"
        f" s, {bwd * calls_per_run / run_busy_us:.3f} of the profiled run's device time")


def slice_phase(model, model_args, batch: int, steps: int, runs: int, seed: int):
    dev = next(model.parameters()).device
    res = model_args["image_size"]
    precond = loading.wrap_precond(model, model_args)
    op = get_operator("gaussian_blur", in_shape=(1, 3, res, res), sigma_s=0.1,
                      kernel_size=61, intensity=3.0, device=dev)
    xs, s0 = schedule(precond, steps)
    cap = edm.required_cov_capacity(xs)
    mech = Recorder(free_hunch(op, res, cap, "dct_diagonal"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    cond = torch.rand((batch, 3, res, res), generator=gen, device=dev) * 2 - 1
    y = op.forward(cond, generator=gen)
    noise = torch.randn((batch, 3, res, res), generator=gen, device=dev)

    forwards = 0

    def denoise(x, sigma):
        nonlocal forwards
        forwards += 1
        return precond(x, sigma)

    gn_calls = 0

    def count(mod, inputs):
        nonlocal gn_calls
        gn_calls += 1

    hooks = [m.register_forward_pre_hook(count) for m in model.modules()
             if isinstance(m, GroupNorm32)]
    in_resblocks = sum(isinstance(m, GroupNorm32) for r in model.modules()
                       if isinstance(r, ResBlock) for m in r.modules())
    n_norms = sum(isinstance(m, GroupNorm32) for m in model.modules())
    say(f"slice: {res}x{res}, batch {batch}, {steps} Heun steps, cov_capacity {cap}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    walls = []
    for run in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if run == 0:
            gn.launches = 0
            forwards = gn_calls = 0
        t0 = time.perf_counter()
        x, _, diag = edm.sample_loop(denoise, mech, noise, y, xs, gen,
                                     sigma0_scaled=s0, collect_diagnostics=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            launches = gn.launches
            counted = dict(forwards=forwards, gn_calls=gn_calls, diag=diag,
                           rank=mech.state.cov.k.cpu().tolist(), x=x)
        say(f"  run {run}: wall {walls[-1]:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for h in hooks:
        h.remove()
    busy = device_breakdown(lambda: edm.sample_loop(denoise, mech, noise, y, xs, gen,
                                                    sigma0_scaled=s0))
    if busy:
        fh = mech.mech
        backward_share(lambda: fh(denoise, noise * s0, y, float(xs["sigma_hat"][0]),
                                  fh.init_state(batch, (3, res, res))),
                       counted["forwards"], busy)

    x, diag = counted["x"], counted["diag"]
    if tuple(x.shape) != (batch, 3, res, res) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"slice: final x {tuple(x.shape)} not finite")
    fw = counted["forwards"]
    # every guided call runs one forward (101 GroupNorms) and one vjp, whose
    # remat recompute runs each ResBlock forward again (its 2 GroupNorms)
    want = fw * (n_norms + in_resblocks)
    say(f"  groupnorm_silu launches {launches} = {fw} UNet forwards x {n_norms} "
        f"+ {fw} vjp recomputes x {in_resblocks} (GroupNorm module calls "
        f"{counted['gn_calls']})")
    if fw != 2 * steps - 1 or not launches == counted["gn_calls"] == want:
        raise AssertionError(f"slice: {launches} launches, {counted['gn_calls']} "
                             f"GroupNorm calls, want {want} over {fw} forwards")
    niter = diag["cg_niter"].numpy()
    optf = diag["cg_optfrac"].numpy()
    say(f"  sigma_hat {np.round(xs['sigma_hat'], 4).tolist()}")
    say(f"  CG niter per stage (heun, second): {niter.tolist()}")
    say(f"  CG converged fraction per stage: {np.round(optf, 3).tolist()}")
    say(f"  CG iterations {int(niter[niter > 0].sum())}, host syncs "
        f"{diag['host_syncs']}")
    say(f"  covariance rank k per sample: {counted['rank']} of {cap}")
    say(f"  final x: finite, shape {tuple(x.shape)}, mean {float(x.mean()):.4f}, "
        f"std {float(x.std()):.4f}")
    return launches, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--runs", type=int, default=2, help="sampling runs; the first "
                    "is counted, every one is timed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port runs on "
              "a CUDA card", file=sys.stderr)
        return 2
    if Path(fht.__file__).resolve().parents[1] != ROOT:
        print(f"chip_smoke: drives the port beside it, but imported "
              f"{fht.__file__}", file=sys.stderr)
        return 2

    smi = card_facts()
    t0 = time.perf_counter()
    model, model_args = loading.load_model(
        str(CKPT_256), str(SETUP_256), dtype=torch.bfloat16,
        init_random_if_missing=True, rng_seed=args.seed, remat=True)
    torch.cuda.synchronize()
    say(f"256 px UNet built ({'checkpoint' if CKPT_256.exists() else 'seeded random'}"
        f" weights) in {time.perf_counter() - t0:.2f} s")
    shapes = gn_shapes_of_forward(model, args.batch, model_args["image_size"], "cuda")
    entry = kernel_phase(shapes)
    reference_phase(args.seed)
    launches, walls = slice_phase(model, model_args, args.batch, args.steps,
                                  args.runs, args.seed)
    say(f"sampling wall time per run (s): {[round(w, 3) for w in walls]} on {smi}")
    entry["launches"] = launches
    say(json.dumps({"kernels": [entry]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
