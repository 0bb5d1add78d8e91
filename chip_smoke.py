#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``free_hunch_tpu_torch``) on one card.

    python3 chip_smoke.py                      # batch 8, 30 Heun steps
    python3 chip_smoke.py --batch 2 --steps 3  # a shorter rehearsal
    python3 chip_smoke.py --k3                 # K3 alone: host and device
                                               # time, every small-layer cut
    python3 chip_smoke.py --gn                 # K1 and K2 alone: per pass and
                                               # per call, every forward shape
    python3 chip_smoke.py --mechanisms         # phases 3b, 4b-4d alone
    python3 chip_smoke.py --ddnm               # phases 3c and 4e alone

Phases, in order; any failure raises and exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, the TF32
   flags the port sets, and the build of every kernel from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. kernels: every hand-written kernel against its plain PyTorch version on
   the card, at every distinct shape a main path gives it, with times, the
   bound and the library call of the same function (timed only, never
   used): K1 (GroupNorm+SiLU) at one bf16 forward's shapes, K2 (GroupNorm+
   affine+SiLU+int8 quantise) at one fused-int8 forward's shapes and K3
   (int8 convolution) at every shape of a fused-int8 guided call: the
   forward, the remat recomputes and the int8 pullbacks, summed per forward
   and per guided call. Times are eager, calls back to back; every kernel
   is also timed as a CUDA graph (the card's time alone), K1's and K2's
   passes by the profiler, and K3's host time to issue a call is read.
3. reference: 32 px Free Hunch slices on the card (kernels) against the same
   slices on the CPU (plain versions), same weights and inputs: the f32
   torso, the fused int8 torso, and the static int8 torso calibrated on each
   side; each int8 module also on its own, on the card's inputs.
3b. mechanisms: a 32 px comparison (f32 torso, 3 Heun steps) for all eight
   conditioning mechanisms on gaussian blur, super-resolution x4 and
   inpainting (one mask drawn on the CPU), and DPS on colorization,
   denoising and phase retrieval: each guided call on the card from the
   CPU slice's inputs and state.
3c. DDNM+ and Free Hunch variants: DDNM+ at 32 px (f32 torso, sigma_y
   0.1, eta 1.0, 10 steps) on Deblurring, SuperResolution x4 and
   Inpainting, each step on the card from the CPU's x_t with the same
   ancestral draws; and Free Hunch with ``algebra_dtype='float64'`` and
   through ``wrap_precond(kind='cosine')`` on the three operators of 3b,
   each guided call on the card from the CPU's inputs and state, under
   3b's limits (the f64 run's wall time beside the f32 one's).
4. slices: the ``bench.py`` protocol in the port. Guided 256x256
   gaussian-blur deblurring with Free Hunch (``online_covariance``,
   DCT-diagonal prior, tailored CG recycling the previous stage's solution,
   vjp guidance gradient) through the full-width, full-depth 256 px ADM
   UNet with seeded random weights and remat, EDM Heun: first on the bf16
   torso, then on the int8 torso with the fused GroupNorm route
   (``quant="int8"``, ``fused_gn_quant=True``). For each, the kernels'
   launch counters are zeroed just before its first run and read just after
   it, and checked against the module calls counted by hooks; one more run
   under ``torch.profiler`` gives the device time by kernel family and the
   device's idle share.
4b. the same protocol on the bf16 torso for super-resolution x4 and for
   inpainting with a random mask, one run each (wall time, peak memory, CG
   niter, K1 launches against the hooks).
4c. a sweep of the seven other mechanisms on gaussian blur, SR x4 and
   inpainting at full width (batch 2, 3 Heun steps): wall ms and K1
   launches per guided call.
4d. one pixel-space and one Fourier-coordinate deblur CG iteration at
   256 px, batch 8, on the same system: the reading behind
   ``cg_coords='auto'``.
4e. DDNM+ through the raw 256 px bf16 UNet on the DDPM grid, batch 8,
   twice the Heun step count (60 steps), sigma_y 0.1, eta 1.0, on the
   gaussian blur, SR x4 and inpainting with a random mask: wall time, peak
   memory, ||A x - y|| / ||y||, the final sample, and K1's launches, equal
   to the hooks' GroupNorm32 count; each operator's count joins K1's
   entry of the ``kernels`` line as ``launches_ddnm_<operator>``. The
   gaussian blur's run once more under the profiler.

The last two lines of standard output are the ``kernels`` JSON object and
the ``device`` JSON object. Without a CUDA card the script prints no result
and exits with code 2.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import free_hunch_tpu_torch as fht
from free_hunch_tpu_torch.guidance import choose_conditioning_mechanism, solvers
from free_hunch_tpu_torch.models import loading
from free_hunch_tpu_torch.models.calibrate import calibrate_qscales
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond
from free_hunch_tpu_torch.models.unet import GroupNorm32, ResBlock, create_model
from free_hunch_tpu_torch.operators import assets, get_operator, masks, svd
from free_hunch_tpu_torch.ops import _nvcc
from free_hunch_tpu_torch.ops import gn_quant as gq
from free_hunch_tpu_torch.ops import groupnorm as gn
from free_hunch_tpu_torch.ops import quant as q
from free_hunch_tpu_torch.samplers import ddnm, edm

ROOT = Path(__file__).resolve().parent
SETUP_256 = ROOT / "models" / "256x256_diffusion_uncond_setup.txt"
CKPT_256 = ROOT / "models" / "256x256_diffusion_uncond.pt"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the tensor
# cores, dense int8 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
# GroupNorm+SiLU arithmetic per element: Welford update 5, normalise+affine 4,
# SiLU (exp, add, divide, multiply) 4
GN_FLOPS_PER_ELEM = {True: 13, False: 9}
# K2 per element: Welford 5, then twice normalise+affine+SiLU 8 (amax and
# quantise passes) plus |.|, max, divide, round, clamp 5: 15 for one pass of
# each, the least the function needs
GNQ_FLOPS_PER_ELEM = 15
GN_ENTRY = dict(name="groupnorm_silu", route="cuda",
                source="free_hunch_tpu_torch/csrc/groupnorm.cu",
                replaces="free_hunch_tpu/ops/pallas_groupnorm.py:109")
GNQ_ENTRY = dict(name="gn_silu_quant", route="cuda",
                 source="free_hunch_tpu_torch/csrc/gn_quant.cu",
                 replaces="free_hunch_tpu/ops/pallas_gn_quant.py:140")
K3_ENTRY = dict(name="int8_conv", route="cuda",
                source="free_hunch_tpu_torch/csrc/int8_conv.cu",
                replaces="free_hunch_tpu/ops/quant.py:96")


def say(*parts):
    print(*parts, flush=True)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` calls, by CUDA events, after one
    warm-up call. Eager (the default, as every kernel of the ``kernels``
    line is timed): the calls back to back, so a call whose launches take
    the host longer than the card's work measures the host. With ``graph``
    the ``reps`` calls are captured in one CUDA graph and its replay is
    timed: the card's time alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del g
    torch.cuda.empty_cache()
    return ms


def host_us(fn, reps: int, batches: int = 1) -> float:
    """Host time to issue one call of ``fn``, in microseconds: ``reps``
    calls back to back on the host clock, up to the last call's return (the
    card runs them asynchronously), after a warm-up call; the median of
    ``batches`` such batches, as the host's clock varies more than the
    card's."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def kernel_name(key: str) -> str:
    """A profiler kernel key without namespace, template arguments and
    parameters: ``gn_stats_kernel`` for ``void (anonymous
    namespace)::gn_stats_kernel<float, true>(float const*, ...)``."""
    k = key.replace("(anonymous namespace)::", "")
    k = re.sub(r"^void\s+", "", k)
    return re.split(r"[<(]", k, maxsplit=1)[0].split("::")[-1].strip()[:60]


def pass_ms(fn, reps: int = 10) -> dict:
    """The device time of each kernel that one call of ``fn`` launches, in
    ms per call, by kernel name, read with ``torch.profiler`` over ``reps``
    calls after a warm-up; empty where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            out[kernel_name(e.key)] += e.self_device_time_total / reps / 1e3
    return dict(out)


def fmt_passes(passes: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in passes.items()) or "not measured"


def zero_counts():
    gn.launches = gq.launches = q.launches = 0


def counts() -> dict:
    return {"groupnorm_silu": gn.launches, "gn_silu_quant": gq.launches,
            "int8_conv": q.launches}


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
    t0 = time.perf_counter()
    reports = _nvcc.build_all()
    say(f"kernels built together in {time.perf_counter() - t0:.2f} s of wall time:")
    for name, report in reports.items():
        if report is None:
            say(f"  {name}: library already built from this source")
            continue
        say(f"  csrc/{name}.cu built in {report['seconds']:.2f} s")
        for line in report["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"    {line.strip()}")
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


def check_gn(shape, dtype, silu, gen, reps=20, backward=True):
    """Kernel vs plain on one shape; returns the measurements: eager ms
    (calls back to back), the card's ms alone (a CUDA graph's replay), each
    pass's device ms, the plain version's and the library call's ms and,
    with ``backward``, the plain-autograd backward's."""
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
    k1 = lambda: gn.groupnorm_silu_cuda(x, g, b, 32, 1e-5, silu)  # noqa: E731
    ms, graph_ms, passes = time_ms(k1, reps), time_ms(k1, reps, graph=True), pass_ms(k1)
    plain_ms = time_ms(lambda: gn.groupnorm_silu_plain(x, g, b, 32, 1e-5, silu),
                       max(2, reps // 4))
    library_ms = time_ms(lib, reps)
    # the guidance vjp's pullback through this call: the autograd.Function's
    # backward, which recomputes the plain version (there is no backward kernel)
    bwd_ms = 0.0
    if backward:
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
                max_abs_err=err, tol=tol, ms=ms, graph_ms=graph_ms, passes=passes,
                plain_ms=plain_ms, library_ms=library_ms, bwd_ms=bwd_ms, bytes_ms=bytes_ms,
                tbps=nbytes / ms / 1e9, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def sum_entry(entry: dict, rows, keys) -> dict:
    """The kernels-line entry of one forward: per-shape measurements times
    their calls, summed; the bound's two terms summed apart."""
    tot = {k: 0.0 for k in keys + ("bytes_ms", "ops_ms")}
    err = 0.0
    passes = Counter()
    for calls, r in rows:
        err = max(err, r["max_abs_err"])
        for k in tot:
            tot[k] += calls * r[k]
        for k, v in r.get("passes", {}).items():
            passes[k] += calls * v
    bound_by = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    out = dict(entry, max_abs_err=err, **{k: tot[k] for k in keys},
               bound_ms=max(tot["bytes_ms"], tot["ops_ms"]), bound_by=bound_by,
               bytes_ms=tot["bytes_ms"], ops_ms=tot["ops_ms"])
    if any("passes" in r for _, r in rows):
        # the function's bytes (each input read once, each output written
        # once) over the eager time: the achieved rate on the least traffic
        out["passes_ms"] = dict(passes)
        out["tbps"] = tot["bytes_ms"] * HBM_BYTES_PER_S / 1e12 / tot["ms"]
    return out


def gn_kernel_phase(forward_shapes: Counter) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    say("groupnorm_silu kernel (K1) vs plain (times in ms per call):")
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
    rows = []
    say("  one bf16 main-path UNet forward, per distinct shape (calls x ms):")
    for (shape, dtype, silu), calls in sorted(forward_shapes.items(),
                                              key=lambda kv: -np.prod(kv[0][0])):
        r = check_gn(shape, dtype, silu, gen)
        rows.append((calls, r))
        say(f"    {calls:3d} x {r['shape']} {r['dtype']} silu={silu}: err "
            f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} (graph {r['graph_ms']:.4f}; "
            f"{fmt_passes(r['passes'])}; {r['tbps']:.2f} TB/s) plain {r['plain_ms']:.4f} "
            f"library {r['library_ms']:.4f} bound {r['bound_ms']:.4f} backward "
            f"{r['bwd_ms']:.4f}")
    e = sum_entry(GN_ENTRY, rows, ("ms", "graph_ms", "plain_ms", "library_ms", "bwd_ms"))
    say(f"  sum over the {sum(forward_shapes.values())} calls of one forward: kernel "
        f"{e['ms']:.3f} ms (graph {e['graph_ms']:.3f} ms; passes "
        f"{fmt_passes(e['passes_ms'])}; {e['tbps']:.2f} TB/s on the function's bytes), "
        f"plain {e['plain_ms']:.3f} ms, library {e['library_ms']:.3f} ms, "
        f"bound {e['bound_ms']:.3f} ms ({e['bound_by']}: {e['bytes_ms']:.3f} ms of bytes at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s, {e['ops_ms']:.3f} ms of f32 operations); "
        f"their backward in the guidance vjp (plain autograd) {e['bwd_ms']:.3f} ms")
    return {k: e[k] for k in list(GN_ENTRY) + ["max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "graph_ms",
                                               "passes_ms", "tbps"]}


def int8_shapes_of_forward(model, batch: int, res: int, dev):
    """K2 shapes (NHWC shape, dtype) and K3 shapes (input, weights, pad,
    output dtype) -> calls, over one no-grad forward of the int8 model, and
    the K3 calls of a guided call's vjp: a forward with grad, then the
    pullback with respect to the input, whose K3 calls are the remat
    recomputes and the int8 pullbacks (``q._int8_pullback``). The wrappers
    are wrapped for those passes only. Checks that every pass launched each
    kernel once per call and that the vjp made one pullback per int8
    module. Returns (K2 forward, K3 forward, K3 remat, K3 pullback)."""
    k2, k3 = Counter(), Counter()
    remat, pullback = Counter(), Counter()
    phase = {"k2": k2, "k3": k3}
    orig2, orig3, orig_pb = gq.gn_silu_quant_cuda, q.int8_conv_cuda, q._int8_pullback

    def rec2(x, gamma, beta, groups=32, eps=1e-5):
        phase["k2"][(tuple(x.shape), x.dtype)] += 1
        return orig2(x, gamma, beta, groups, eps)

    def rec3(xq, wk, ascale, wscale, pad, out_dtype=torch.float32, stride=1):
        phase["k3"][(tuple(xq.shape), tuple(wk.shape), pad, out_dtype)] += 1
        return orig3(xq, wk, ascale, wscale, pad, out_dtype, stride)

    def rec_pb(*args):
        phase["k3"] = pullback
        try:
            return orig_pb(*args)
        finally:
            phase["k3"] = remat

    x = torch.zeros((batch, 3, res, res), device=dev)
    t = torch.full((batch,), 500.0, device=dev)
    before = counts()
    gq.gn_silu_quant_cuda, q.int8_conv_cuda, q._int8_pullback = rec2, rec3, rec_pb
    try:
        with torch.no_grad():
            model(x, t)
        torch.cuda.synchronize()
        after = counts()
        phase["k2"], phase["k3"] = Counter(), Counter()
        xg = x.requires_grad_(True)
        out = model(xg, t)
        phase["k3"] = remat
        torch.autograd.grad(out, xg, torch.ones_like(out))
        torch.cuda.synchronize()
    finally:
        gq.gn_silu_quant_cuda, q.int8_conv_cuda, q._int8_pullback = orig2, orig3, orig_pb
    n2, n3 = sum(k2.values()), sum(k3.values())
    if (n2, n3) != (after["gn_silu_quant"] - before["gn_silu_quant"],
                    after["int8_conv"] - before["int8_conv"]) or not (n2 and n3):
        raise AssertionError(f"one int8 forward: {n2} K2 and {n3} K3 calls, launches "
                             f"{before} -> {after}")
    n_int8 = sum(isinstance(m, (q.QuantConv, q.QuantDense)) for m in model.modules())
    n_remat, n_pb = sum(remat.values()), sum(pullback.values())
    if n_pb != n_int8 or counts()["int8_conv"] - after["int8_conv"] != n3 + n_remat + n_pb:
        raise AssertionError(f"one vjp: {n_pb} pullbacks for {n_int8} int8 modules, "
                             f"{n_remat} recomputes")
    say(f"one fused-int8 UNet forward at batch {batch}: {n2} K2 launches at {len(k2)} "
        f"distinct shapes, {n3} K3 launches at {len(k3)} distinct shapes; its vjp: "
        f"{n_remat} K3 remat recomputes, {n_pb} K3 pullbacks at {len(pullback)} "
        f"distinct shapes")
    return k2, k3, remat, pullback


def check_gn_quant_once(x, g, b, label):
    """K2 vs plain on one input: the codes equal except where y / s lies
    within rounding of a half-integer (there: one step, on at most 1e-4 of
    the codes), the scales to 1e-6 relative. Where the tree has K2's
    abs-max from the statistics' extremes, the call also equals, bitwise,
    the call forced through the two-pass path's full abs-max pass. Returns (max code
    difference, fraction of codes that differ, scale error, samples that
    took the full pass or None)."""
    xq, s = gq.gn_silu_quant_cuda(x, g, b)
    wq, ws = gq.gn_silu_quant_plain(x, g, b)
    torch.cuda.synchronize()
    d = (xq.int() - wq.int()).abs()
    err, frac = int(d.max()), float((d > 0).float().mean())
    rel = float(((s - ws).abs() / ws).max())
    if err > 1 or frac > 1e-4 or rel > 1e-6:
        raise AssertionError(f"gn_silu_quant kernel {label}: code diff {err} on {frac} "
                             f"of the codes, scale rel err {rel}")
    flagged = None
    if hasattr(gq, "_gn_silu_quant_launch"):
        fq, fs, flags = gq._gn_silu_quant_launch(x, g, b, 32, 1e-5)
        full_q, full_s, _ = gq._gn_silu_quant_launch(x, g, b, 32, 1e-5, full=True,
                                                     path="two-pass")
        torch.cuda.synchronize()
        if not (torch.equal(fq, xq) and torch.equal(fs, s)):
            raise AssertionError(f"gn_silu_quant kernel {label}: two calls differ")
        if not (torch.equal(full_s, s) and torch.equal(full_q, xq)):
            raise AssertionError(
                f"gn_silu_quant kernel {label}: the scale from the extremes differs from "
                f"the full abs-max pass's on samples {(full_s != s).flatten().nonzero().tolist()}"
                f" (flags {flags.tolist()})")
        flagged = int(flags.sum())
    return err, frac, rel, flagged


def check_gn_quant(shape, dtype, gen, reps=20):
    """K2 vs plain on one shape (``check_gn_quant_once``), then the same
    with sample 0's affine narrowed and shifted (gamma / 5, beta / 10 -
    1.28) so that every t of the sample is negative and its abs-max lies in
    the SiLU's negative lobe, where only the full pass finds it; and K2's
    times: eager, a CUDA graph's replay, each pass's device time."""
    n, c = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn((n, c), generator=gen, device="cuda") * 0.2 + 1
    b = torch.randn((n, c), generator=gen, device="cuda") * 0.2
    err, frac, rel, flagged = check_gn_quant_once(x, g, b, f"{shape}")
    gneg, bneg = g.clone(), b.clone()
    gneg[0] *= 0.2
    bneg[0] = bneg[0] * 0.1 - 1.28
    err2, frac2, rel2, flagged2 = check_gn_quant_once(x, gneg, bneg,
                                                      f"{shape} sample 0 negative")
    k2 = lambda: gq.gn_silu_quant_cuda(x, g, b)  # noqa: E731
    ms, graph_ms, passes = time_ms(k2, reps), time_ms(k2, reps, graph=True), pass_ms(k2)
    plain_ms = time_ms(lambda: gq.gn_silu_quant_plain(x, g, b), max(2, reps // 4))
    # x read once, the codes written once, the (n, c) affine and the scales
    nbytes = x.numel() * (x.element_size() + 1) + 2 * n * c * 4 + n * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = GNQ_FLOPS_PER_ELEM * x.numel() / F32_FLOP_PER_S * 1e3
    return dict(max_abs_err=float(max(err, err2)), frac=max(frac, frac2),
                scale_rel=max(rel, rel2), flagged=(flagged, flagged2), ms=ms,
                graph_ms=graph_ms, passes=passes, tbps=nbytes / ms / 1e9,
                plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms))


def im2col(xq, kh: int, kw: int, pad: int):
    """(n*Ho*Wo, kh*kw*I) int8 patches in K3's K order, for the yardstick."""
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    cols = xp.unfold(1, kh, 1).unfold(2, kw, 1)          # (n, Ho, Wo, I, kh, kw)
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * xq.shape[-1])


def check_int8_conv(xs, ws, pad, out_dtype, gen, reps=10):
    """K3 vs plain on one shape: the int32 sums bitwise equal, the output
    bitwise equal to the plain epilogue on them. The yardsticks, timed only:
    ``torch._int_mm`` on an explicit im2col (the same int32 sums) and the
    bf16 cuDNN convolution of the same shape."""
    n, o = xs[0], ws[0]
    kh, kw = ws[1], ws[2]
    xq = torch.randint(-127, 128, xs, generator=gen, device="cuda", dtype=torch.int8)
    wk = torch.randint(-127, 128, ws, generator=gen, device="cuda", dtype=torch.int8)
    asc = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
    wsc = torch.rand(o, generator=gen, device="cuda") * 1e-3 + 1e-4
    acc = q.int8_conv_cuda(xq, wk, None, None, pad, torch.int32)
    want = q.int8_conv_plain(xq, wk, None, None, pad, torch.int32)
    out = q.int8_conv_cuda(xq, wk, asc, wsc, pad, out_dtype)
    torch.cuda.synchronize()
    if not torch.equal(acc, want):
        raise AssertionError(f"int8_conv kernel {xs} x {ws}: int32 sums differ by "
                             f"{int((acc - want).abs().max())}")
    if not torch.equal(out, q._epilogue(want, asc, wsc, out_dtype)):
        raise AssertionError(f"int8_conv kernel {xs} x {ws}: epilogue not bitwise equal")
    # eager times, as every kernel of the kernels line is timed, and as CUDA
    # graphs: the card's time without the host's; the host's time to issue a call
    k3 = lambda: q.int8_conv_cuda(xq, wk, asc, wsc, pad, out_dtype)  # noqa: E731
    ms, graph_ms = time_ms(k3, reps), time_ms(k3, reps, graph=True)
    host = host_us(k3, reps, batches=3)
    plain_ms = time_ms(lambda: q.int8_conv_plain(xq, wk, asc, wsc, pad, out_dtype), 2)
    cols = im2col(xq, kh, kw, pad)
    bmat = wk.reshape(o, -1).t()
    try:
        library_ms = time_ms(lambda: torch._int_mm(cols, bmat), reps)
        library_graph_ms = time_ms(lambda: torch._int_mm(cols, bmat), reps, graph=True)
    except RuntimeError as e:
        say(f"    torch._int_mm refused {tuple(cols.shape)} x {tuple(bmat.shape)}: {e}")
        library_ms = library_graph_ms = None
    del cols
    xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
    wb = wk.permute(0, 3, 1, 2).to(torch.bfloat16)
    cudnn_ms = time_ms(lambda: F.conv2d(xb, wb, padding=pad), reps)
    cudnn_graph_ms = time_ms(lambda: F.conv2d(xb, wb, padding=pad), reps, graph=True)
    m = acc.shape[0] * acc.shape[1] * acc.shape[2]
    ops = 2 * m * o * kh * kw * xs[-1]
    nbytes = xq.numel() + wk.numel() + m * o * out.element_size() + 4 * (n + o)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OP_PER_S * 1e3
    plan = q.int8_conv_plan(n, xs[1], xs[2], xs[3], o, kh, kw, pad,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(max_abs_err=0.0, ms=ms, graph_ms=graph_ms, host_us=host, plain_ms=plain_ms,
                library_ms=library_ms, library_graph_ms=library_graph_ms, cudnn_ms=cudnn_ms,
                cudnn_graph_ms=cudnn_graph_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms), tops=ops / ms / 1e9,
                graph_tops=ops / graph_ms / 1e9,
                cut=f"{plan.bm}x{plan.bn} tiles x {plan.splits} K splits = {plan.units} units")


def int8_kernel_phase(k2_shapes: Counter, k3_shapes: Counter, k3_remat: Counter,
                      k3_pullback: Counter):
    gen = torch.Generator(device="cuda").manual_seed(1)
    say("gn_silu_quant kernel (K2) vs plain, one fused-int8 forward per distinct "
        "shape (calls x ms; codes equal except ties, scales to 1e-6):")
    rows = []
    for (shape, dtype), calls in sorted(k2_shapes.items(), key=lambda kv: -np.prod(kv[0][0])):
        r = check_gn_quant(shape, dtype, gen)
        rows.append((calls, r))
        say(f"    {calls:3d} x {shape} {str(dtype)[6:]}: code diff {r['max_abs_err']:.0f} on "
            f"{r['frac']:.2e}, scale err {r['scale_rel']:.2e}, samples through the full "
            f"abs-max pass {r['flagged']}; kernel {r['ms']:.4f} (graph {r['graph_ms']:.4f}; "
            f"{fmt_passes(r['passes'])}; {r['tbps']:.2f} TB/s) plain {r['plain_ms']:.4f} "
            f"bound {r['bound_ms']:.4f}")
    e2 = sum_entry(GNQ_ENTRY, rows, ("ms", "graph_ms", "plain_ms"))
    e2["library_ms"] = None
    say(f"  K2 sum over the {sum(k2_shapes.values())} calls of one forward: kernel "
        f"{e2['ms']:.3f} ms (graph {e2['graph_ms']:.3f} ms; passes "
        f"{fmt_passes(e2['passes_ms'])}; {e2['tbps']:.2f} TB/s on the function's bytes), "
        f"plain {e2['plain_ms']:.3f} ms, bound {e2['bound_ms']:.3f} ms "
        f"({e2['bound_by']}); no single PyTorch call computes it (library: none)")
    say("int8_conv kernel (K3) vs plain at every distinct shape of a guided call "
        "(forward, remat recompute, pullback: calls each; int32 sums and epilogue bitwise; "
        "ms per call, eager = calls back to back, graph = a CUDA graph's replay; host = "
        "the host's time to issue one call):")
    rows = {}
    for key in sorted(set(k3_shapes) | set(k3_pullback),
                      key=lambda kv: (kv in k3_pullback, -np.prod(kv[0]) * kv[1][0])):
        xs, ws, pad, odt = key
        r = rows[key] = check_int8_conv(xs, ws, pad, odt, gen)
        lib = "refused" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} (graph {r['library_graph_ms']:.4f})"
        say(f"    {k3_shapes[key]:3d}+{k3_remat[key]:2d}+{k3_pullback[key]:2d} x {xs} * {ws} "
            f"pad {pad} -> {str(odt)[6:]}: kernel eager {r['ms']:.4f} ({r['tops']:.0f} TOP/s), "
            f"graph {r['graph_ms']:.4f} ({r['graph_tops']:.0f} TOP/s), host "
            f"{r['host_us']:.1f} us; plain {r['plain_ms']:.4f} _int_mm {lib} cudnn_bf16 "
            f"{r['cudnn_ms']:.4f} (graph {r['cudnn_graph_ms']:.4f}) bound "
            f"{r['bound_ms']:.4f}; {r['cut']}")
    lib_keys = ("library_ms", "library_graph_ms")
    have_lib = all(r["library_ms"] is not None for r in rows.values())
    if not have_lib:
        for r in rows.values():
            r.update(dict.fromkeys(lib_keys, 0.0))
    keys = ("ms", "graph_ms", "host_us", "plain_ms", "cudnn_ms", "cudnn_graph_ms") + lib_keys
    e3 = sum_entry(K3_ENTRY, [(c, rows[k]) for k, c in k3_shapes.items()], keys)
    guided = Counter(k3_shapes) + Counter(k3_remat) + Counter(k3_pullback)
    eg = sum_entry(K3_ENTRY, [(c, rows[k]) for k, c in guided.items()], keys)
    if not have_lib:
        for e in (e3, eg):
            e.update(dict.fromkeys(lib_keys))
    for label, e, calls in (("one forward", e3, sum(k3_shapes.values())),
                            ("one guided call", eg, sum(guided.values()))):
        lib = "n/a" if e["library_ms"] is None else \
            f"{e['library_ms']:.3f} ms (graph {e['library_graph_ms']:.3f} ms)"
        say(f"  K3 sum over the {calls} calls of {label}: kernel eager {e['ms']:.3f} ms (graph "
            f"{e['graph_ms']:.3f} ms; the host issues them in {e['host_us'] / 1e3:.3f} ms), "
            f"plain {e['plain_ms']:.3f} ms, _int_mm on im2col {lib}, bf16 cuDNN conv "
            f"{e['cudnn_ms']:.3f} ms (graph {e['cudnn_graph_ms']:.3f} ms), bound "
            f"{e['bound_ms']:.3f} ms ({e['bound_by']}: {e['ops_ms']:.3f} ms of int8 operations "
            f"at {INT8_OP_PER_S / 1e12:.0f} TOP/s, {e['bytes_ms']:.3f} ms of bytes)")
    keep = list(GN_ENTRY) + ["max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms"]
    # K3 also carries its time and _int_mm's as CUDA graphs: the card's time alone
    return ({k: e2[k] for k in keep + ["graph_ms", "passes_ms", "tbps"]},
            {k: e3[k] for k in keep + ["graph_ms", "library_graph_ms"]})


def by_resolution(rows) -> str:
    """Eager ms of one forward's calls by spatial size: 256, 128, 64 and
    8-32 px, each with its share of the sum."""
    buckets = Counter()
    for calls, r in rows:
        h = r["shape"][1]
        buckets["8-32 px" if h <= 32 else f"{h} px"] += calls * r["ms"]
    total = sum(buckets.values())
    return ", ".join(f"{k} {v:.3f} ms ({v / total:.3f})" for k, v in
                     sorted(buckets.items(), key=lambda kv: -kv[1]))


def two_pass_instead(shape, dtype, quant: bool, gen):
    """Where the tree plans a call on K1's or K2's one-launch cluster path,
    the call's times on the two-pass path instead (eager, graph, passes);
    else None."""
    if not hasattr(gn, "gn_plan"):
        return None
    n, c = shape[0], shape[-1]
    s = int(np.prod(shape[1:-1]))
    size = torch.tensor([], dtype=dtype).element_size()
    if gn.gn_plan(n, s, c, 32, size, gn.device_sms("cuda"), quant).path != "cluster":
        return None
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    if quant:
        g = torch.randn((n, c), generator=gen, device="cuda") * 0.2 + 1
        b = torch.randn((n, c), generator=gen, device="cuda") * 0.2
        fn = lambda: gq._gn_silu_quant_launch(x, g, b, path="two-pass")  # noqa: E731
    else:
        g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        fn = lambda: gn._groupnorm_launch(x, g, b, 32, 1e-5, True,  # noqa: E731
                                          path="two-pass")
    return time_ms(fn, 20), time_ms(fn, 20, graph=True), pass_ms(fn)


def gn_phase(batch: int, seed: int):
    """K1 and K2 alone (``--gn``), at every distinct shape of one forward
    of the 256 px UNet at ``batch``: K1's of the bf16 torso, K2's of the
    fused-int8 torso, found by the shape hooks. Each is held to its plain
    version as in the full run and timed per call (eager, and a CUDA
    graph's replay: the card's time alone), per pass (the profiler's device
    time of each kernel it launches) and per forward, beside the plain
    version, ``group_norm`` + ``silu`` (K1) and the bytes bound. It uses
    only functions that every K2 tree of the port has, so a copy of this
    script beside an older tree's checkout measures that tree."""
    sums = {}
    for label, quant in (("K1", None), ("K2", "int8")):
        model, model_args = loading.load_model(
            str(CKPT_256), str(SETUP_256), dtype=torch.bfloat16, init_random_if_missing=True,
            rng_seed=seed, remat=True, quant=quant, fused_gn_quant=quant is not None)
        res = model_args["image_size"]
        shapes = gn_shapes_of_forward(model, batch, res, "cuda") if quant is None else \
            int8_shapes_of_forward(model, batch, res, "cuda")[0]
        del model
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(3)
        rows = []
        say(f"{label} alone at every distinct shape of one forward at batch {batch} (ms per "
            f"call: eager, graph, and each pass's device time):")
        for key, calls in sorted(shapes.items(), key=lambda kv: -np.prod(kv[0][0])):
            if quant is None:
                shape, dtype, silu = key
                r = check_gn(shape, dtype, silu, gen, backward=False)
                extra = f"plain {r['plain_ms']:.4f} group_norm+silu {r['library_ms']:.4f}"
            else:
                shape, dtype = key
                r = dict(check_gn_quant(shape, dtype, gen), shape=shape)
                extra = (f"code diff {r['max_abs_err']:.0f} on {r['frac']:.2e}, scale err "
                         f"{r['scale_rel']:.2e}, full-pass samples {r['flagged']}; plain "
                         f"{r['plain_ms']:.4f}")
            rows.append((calls, r))
            say(f"  {calls:3d} x {tuple(shape)} {str(dtype)[6:]}: eager {r['ms']:.4f} graph "
                f"{r['graph_ms']:.4f} ({fmt_passes(r['passes'])}) {r['tbps']:.3f} TB/s; "
                f"bound {r['bound_ms']:.4f}; {extra}")
            alt = two_pass_instead(shape, dtype, quant is not None, gen)
            if alt:
                say(f"        on the two-pass path instead: eager {alt[0]:.4f} graph "
                    f"{alt[1]:.4f} ({fmt_passes(alt[2])})")
        keys = ("ms", "graph_ms", "plain_ms") + (("library_ms",) if quant is None else ())
        e = sum_entry({}, rows, keys)
        sums[label] = e
        say(f"  {label} sum over the {sum(shapes.values())} calls of one forward: eager "
            f"{e['ms']:.3f} ms, graph {e['graph_ms']:.3f} ms, passes "
            f"{fmt_passes(e['passes_ms'])}; {e['tbps']:.3f} TB/s on the function's bytes; "
            f"bound {e['bound_ms']:.3f} ms ({e['bound_by']}); plain {e['plain_ms']:.3f} ms"
            + (f"; group_norm+silu {e['library_ms']:.3f} ms" if quant is None else ""))
        say(f"  {label} eager by resolution: {by_resolution(rows)}")
    return sums


# K3 alone (``--k3``), at shapes of the 256 px UNet at batch 8: the largest
# forward call, a 32 px 3x3, an 8 px 3x3 that splits K and an 8 px attention
# qkv product ...
K3_PROBES = (((8, 256, 256, 512), (256, 3, 3, 512), 1),
             ((8, 32, 32, 512), (512, 3, 3, 512), 1),
             ((8, 8, 8, 1024), (1024, 3, 3, 1024), 1),
             ((8, 64, 1, 1024), (3072, 1, 1, 1024), 0))
# ... and the 8 and 16 px shapes whose cuts the planner weighs, forward and
# pullback, with the K splits tried
K3_CUT_SHAPES = (((8, 8, 8, 1024), (1024, 3, 3, 1024), 1),
                 ((8, 8, 8, 2048), (1024, 3, 3, 2048), 1),
                 ((8, 16, 16, 1024), (1024, 3, 3, 1024), 1),
                 ((8, 64, 1, 1024), (1024, 1, 1, 1024), 0),
                 ((8, 64, 1, 1024), (3072, 1, 1, 1024), 0),
                 ((8, 8, 8, 1024), (2048, 1, 1, 1024), 0))
K3_SPLITS = (1, 2, 4, 8, 9, 16)


def k3_phase():
    """K3 alone, bf16 output: at each probe shape the host's time to issue
    one call of the wrapper ``q.int8_conv_cuda`` and of the layer as the
    model calls it (``q.int8_conv``: dynamic quantisation of a bf16 input,
    then K3), and the card's time, eager and as a CUDA graph. It uses only
    functions that every tree of the port since K3 has, so a copy of this
    script beside an older tree measures that tree. Then, where the tree
    can force K3's cut, every cut of ``K3_CUT_SHAPES``: its device time as
    a CUDA graph, held bitwise to the planner's cut; ``int8_conv_plan``'s
    time model is read off this table."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    # the layer issues about a dozen kernels a call: 50 calls stay well inside
    # the launch queue, so the host never waits for the card while timed
    say("K3 alone, bf16 out, per call (host: time to issue it, the median of 7 batches of "
        "100 calls, 50 of the layer; eager: calls back to back; graph: a CUDA graph's "
        "replay):")
    for xs, ws, pad in K3_PROBES:
        xq = torch.randint(-127, 128, xs, generator=gen, device="cuda", dtype=torch.int8)
        wk = torch.randint(-127, 128, ws, generator=gen, device="cuda", dtype=torch.int8)
        asc = torch.rand(xs[0], generator=gen, device="cuda") + 0.1
        wsc = torch.rand(ws[0], generator=gen, device="cuda") + 0.1
        w = torch.randn((ws[1], ws[2], ws[3], ws[0]), generator=gen, device="cuda") * 0.05
        qw = q.prepare_conv_weight(w)
        x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16)
        k3 = lambda: q.int8_conv_cuda(xq, wk, asc, wsc, pad, torch.bfloat16)  # noqa: E731
        layer = lambda: q.int8_conv(x, w, pad, qw)  # noqa: E731
        with torch.no_grad():
            say(f"  {xs} * {ws} pad {pad}: K3 host {host_us(k3, 100, 7):.2f} us, eager "
                f"{time_ms(k3, 20) * 1e3:.2f} us, graph {time_ms(k3, 20, graph=True) * 1e3:.2f} "
                f"us; layer (quantise + K3) host {host_us(layer, 50, 7):.2f} us, eager "
                f"{time_ms(layer, 20) * 1e3:.2f} us")
    if not hasattr(q, "_int8_conv_launch"):
        say("  this tree cannot force K3's cut: no table of cuts")
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"every cut of the 8 and 16 px shapes on {sms} SMs, bf16 out (device time as a CUDA "
        f"graph; each output bitwise equal to the planner's cut's):")
    for xs, ws, pad in K3_CUT_SHAPES:
        xq = torch.randint(-127, 128, xs, generator=gen, device="cuda", dtype=torch.int8)
        wk = torch.randint(-127, 128, ws, generator=gen, device="cuda", dtype=torch.int8)
        asc = torch.rand(xs[0], generator=gen, device="cuda") + 0.1
        wsc = torch.rand(ws[0], generator=gen, device="cuda") + 0.1
        plan = q.int8_conv_plan(*xs, ws[0], ws[1], ws[2], pad, sms)
        want = q.int8_conv_cuda(xq, wk, asc, wsc, pad, torch.bfloat16)
        ops = 2 * xs[0] * xs[1] * xs[2] * ws[0] * ws[1] * ws[2] * xs[3]  # "same" padding
        for bn in (256, 128):
            for splits in K3_SPLITS:
                if ws[0] % bn or splits > plan.k_blocks:
                    continue
                call = lambda: q._int8_conv_launch(xq, wk, asc, wsc, pad,  # noqa: E731
                                                   torch.bfloat16, (bn, splits))
                if not torch.equal(call(), want):
                    raise AssertionError(f"K3 {xs} * {ws}: cut ({bn}, {splits}) differs from "
                                         f"the planner's")
                us = time_ms(call, 20, graph=True) * 1e3
                units = plan.m_tiles * (ws[0] // bn) * splits
                say(f"    {xs} * {ws} pad {pad}: 128x{bn} tiles x {splits} splits = {units} "
                    f"units: {us:.2f} us ({ops / us / 1e6:.0f} TOP/s)"
                    + (" <- planner" if (bn, splits) == (plan.bn, plan.splits) else ""))


# -- phases 3 and 4: the slices ----------------------------------------------

class Recorder:
    """Pass-through guidance mechanism that keeps the last state."""

    def __init__(self, mech):
        self.mech, self.state = mech, None

    def init_state(self, batch, img_shape):
        return self.mech.init_state(batch, img_shape)

    def __call__(self, denoise, x_t, y, sigma, state):
        x0, self.state = self.mech(denoise, x_t, y, sigma, state)
        return x0, self.state


def free_hunch(op, res: int, cap: int, prior: str, **kw):
    """The bench.py mechanism configuration (``kw`` overrides a knob)."""
    return choose_conditioning_mechanism("online_covariance")(
        cond_scaling=1.0, forward_operator=op, clip_x0_mean=False,
        image_base_covariance=prior, init_denoiser_variance=1.0,
        init_noise_variance=80.0**2, data_dim=3 * res * res, cov_capacity=cap,
        solver_type="customcuda", max_rtol=1.0, cg_maxiter=5000, cg_coords="pixel",
        cg_warm_start="prev", guidance_gradient="vjp", guidance_vjp_below=2.0, **kw)


def schedule(precond, steps: int):
    return edm.prepare_schedule(
        round_sigma=precond.round_sigma, net_sigma_min=precond.sigma_min,
        net_sigma_max=precond.sigma_max, num_steps=steps, solver="heun",
        discretization="edm", schedule="linear", scaling="none")


TINY = dict(image_size=32, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="8", num_head_channels=16)


def reference_phase(seed: int):
    """32 px slice, f32 UNet, 3 Heun steps: card (kernels) vs CPU (plain)."""
    res, batch, steps = 32, 2, 3
    tiny = dict(TINY, dtype=torch.float32)
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
    say(f"reference 32 px f32 slice, card vs CPU: per-step max |dx| {err.tolist()} "
        f"(limits {limit.tolist()}), CG niter card {ng.tolist()} "
        f"cpu {nc.tolist()}, card kernel launches {lg}")
    if not (np.isfinite(tg).all() and (err <= limit).all() and (ng == nc).all()):
        raise AssertionError("reference phase: card and CPU slices disagree")


# The mechanism reference: every conditioning mechanism on the operators its
# solvers serve, DPS also on the operators it needs only the forward of.
MECHANISMS = ("online_covariance", "dps", "pigdm", "pigdm_videodiff_schedule",
              "peng_convert", "peng_analytic", "tmpd", "diffpir")
MECH_OPS = ("gaussian_blur", "super_resolution", "inpainting")
DPS_ONLY_OPS = ("colorization", "noise", "phase_retrieval")
MECH_REF_CASES = tuple([(m, o) for m in MECHANISMS for o in MECH_OPS]
                       + [("dps", o) for o in DPS_ONLY_OPS])
# the limits of ``reference_phase``, per guided call: each call's x0 before
# the last within 1e-3 of its own max |x0|, the last (sigma 0.01) within 4e-3
MECH_REF_CALL_REL, MECH_REF_LAST_ABS = 1e-3, 4e-3
# Free Hunch variants of phase 3c: name -> (mechanism knobs, preconditioner)
FH_VARIANTS = {"online_covariance_f64": (dict(algebra_dtype="float64"), "linear"),
               "online_covariance_cosine": ({}, "cosine")}
FH_VARIANT_CASES = tuple((m, o) for m in FH_VARIANTS for o in MECH_OPS)


def mechanism(name: str, op, res: int, cap: int):
    """Free Hunch as ``reference_phase`` runs it (flat DCT prior), one of
    its ``FH_VARIANTS``, or a stateless mechanism with its defaults at
    cond_scaling 1."""
    if name == "online_covariance":
        return free_hunch(op, res, cap, "dct_diagonal_noinfo")
    if name in FH_VARIANTS:
        return free_hunch(op, res, cap, "dct_diagonal_noinfo", **FH_VARIANTS[name][0])
    return choose_conditioning_mechanism(name)(cond_scaling=1.0, forward_operator=op)


def state_to(state, dev):
    """A mechanism state (nested NamedTuples of tensors and host scalars)
    with every tensor on ``dev``."""
    if torch.is_tensor(state):
        return state.to(dev)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(state_to(v, dev) for v in state))
    return state


class CallRecorder:
    """Pass-through guidance mechanism that records every call: its x_t,
    sigma and state in, its x0 and CG count out."""

    def __init__(self, mech):
        self.mech, self.calls = mech, []

    def init_state(self, batch, img_shape):
        return self.mech.init_state(batch, img_shape)

    def __call__(self, denoise, x_t, y, sigma, state):
        x0, new = self.mech(denoise, x_t, y, sigma, state)
        self.calls.append(dict(x_t=x_t, sigma=sigma, state=state, x0=x0.cpu().numpy(),
                               niter=new.cg_niter))
        return x0, new


class MechanismReference:
    """The 32 px witness of every mechanism: seeded weights of the tiny f32
    UNet, noise, a ground truth measured once on the CPU by each operator
    (so both sides read the same y), and one inpainting mask drawn once on
    the CPU (p ~ U(0.1, 0.3), the eval defaults); 3 Heun steps, 5 guided
    calls.

    The CPU runs the slice; the card runs each guided call on the CPU's x_t,
    sigma and mechanism state (teacher forcing), and each call's x0 and CG
    count are compared. Compared step by step instead, DPS read 3.7x its
    limit on an H100 (PERF.md, section 6): at sigma 0.01 a pixel whose
    denoiser output sits on the clamp at +-1 on one device and not on the
    other flips its DPS gradient, and the Heun corrector multiplies that
    call's update by h / (2 sigma') = 173 into the step's x."""

    res, batch, steps = 32, 2, 3

    def __init__(self, seed: int):
        res, batch = self.res, self.batch
        self.tiny = dict(TINY, dtype=torch.float32)
        self.state = loading.random_init_(create_model(**self.tiny), seed=seed).state_dict()
        rng = np.random.default_rng(seed + 2)
        self.noise = rng.normal(size=(batch, 3, res, res)).astype(np.float32)
        self.truth = rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32)
        self.mask = masks.generate_mask(torch.Generator().manual_seed(seed),
                                        {"mask_type": "random", "image_size": res,
                                         "mask_prob_range": (0.1, 0.3)})
        self.models, self.ys = {}, {}

    def operator(self, name: str, dev):
        kw = {"mask": self.mask} if name == "inpainting" else {}
        return get_operator(name, in_shape=(1, 3, self.res, self.res), sigma_s=0.1,
                            device=dev, **kw)

    def run(self, mech: str, op_name: str, dev: str, teacher=None, nudge: float = 0.0) -> dict:
        """One side: each guided call's x0 and CG count, and the K1
        launches. Without ``teacher`` the slice runs and records its calls;
        with it (the CPU side's result) each of its calls runs again here.
        ``nudge`` multiplies every denoiser output by (1 + nudge N(0, 1)),
        a stand-in for another device's rounding. A ``FH_VARIANTS`` case
        runs through its preconditioner."""
        kind = FH_VARIANTS.get(mech, ({}, "linear"))[1]
        if (dev, kind) not in self.models:
            with torch.device(dev):
                model = create_model(**self.tiny)
            model.load_state_dict(self.state)
            self.models[dev, kind] = loading.wrap_precond(
                model.eval().requires_grad_(False), {"image_size": self.res}, kind)
        if op_name not in self.ys:
            self.ys[op_name] = self.operator(op_name, "cpu").forward(
                torch.as_tensor(self.truth), noiseless=True)
        precond = denoise = self.models[dev, kind]
        if nudge:
            rng = np.random.default_rng(1)

            def denoise(x, sigma):
                x0, var = precond(x, sigma)
                n = torch.as_tensor(rng.normal(size=tuple(x0.shape)), dtype=x0.dtype,
                                    device=x0.device)
                return x0 * (1 + nudge * n), var
        xs, s0 = schedule(precond, self.steps)
        mech_obj = mechanism(mech, self.operator(op_name, dev), self.res,
                             edm.required_cov_capacity(xs))
        y = self.ys[op_name].to(dev)
        before = gn.launches
        sync(dev)
        t0 = time.perf_counter()
        if teacher is None:
            rec = CallRecorder(mech_obj)
            edm.sample_loop(denoise, rec, torch.as_tensor(self.noise, device=dev), y, xs,
                            sigma0_scaled=s0)
            calls = rec.calls
        else:
            calls = []
            for c in teacher["calls"]:
                x0, new = mech_obj(denoise, c["x_t"].to(dev), y, c["sigma"],
                                   state_to(c["state"], dev))
                calls.append(dict(x0=x0.cpu().numpy(), niter=new.cg_niter))
        sync(dev)
        return dict(calls=calls, launches=gn.launches - before,
                    wall_s=time.perf_counter() - t0)


def mechanism_reference_failures(cpu: dict, card: dict) -> tuple:
    """(per-call max |dx0|, per-call limit, what breaks the limits or equal
    CG niter) of one case, card against CPU."""
    want = [c["x0"] for c in cpu["calls"]]
    got = [c["x0"] for c in card["calls"]]
    limit = np.array([MECH_REF_CALL_REL * np.abs(w).max() for w in want])
    limit[-1] = MECH_REF_LAST_ABS
    err = np.array([np.abs(g - w).max() for g, w in zip(got, want)])
    bad = []
    if not all(np.isfinite(g).all() for g in got):
        bad.append("card output not finite")
    bad += [f"call {i} max |dx0| {e:.3g} > {lim:.3g}"
            for i, (e, lim) in enumerate(zip(err, limit)) if not e <= lim]
    n_cpu = [c["niter"] for c in cpu["calls"]]
    n_card = [c["niter"] for c in card["calls"]]
    if n_card != n_cpu:
        bad.append(f"CG niter card {n_card} cpu {n_cpu}")
    return err, limit, bad


def mechanism_reference_phase(seed: int, card: str = "cuda"):
    """32 px, f32 UNet, 3 Heun steps: every mechanism x operator case, each
    guided call on the card (K1) from the CPU's inputs against the CPU
    (plain version); any call outside the limits, with another CG count, or
    a case without K1 launches on the card raises."""
    ref = MechanismReference(seed)
    failed = []
    t0 = time.perf_counter()
    for mech, op in MECH_REF_CASES:
        cpu = ref.run(mech, op, "cpu")
        gpu = ref.run(mech, op, card, teacher=cpu)
        err, limit, bad = mechanism_reference_failures(cpu, gpu)
        if cpu["launches"] != 0 or gpu["launches"] == 0:
            bad.append(f"K1 launches cpu {cpu['launches']} card {gpu['launches']}")
        say(f"mechanism reference 32 px {mech} on {op}, card vs CPU, per guided call: max "
            f"|dx0| {[float(f'{e:.3g}') for e in err]} (limits "
            f"{[float(f'{v:.3g}') for v in limit]}), CG niter "
            f"{[c['niter'] for c in gpu['calls']]}, card K1 launches {gpu['launches']}"
            + (f"; FAILS: {bad}" if bad else ""))
        if bad:
            failed.append((mech, op, bad))
    say(f"mechanism reference: {len(MECH_REF_CASES)} cases in {time.perf_counter() - t0:.1f} s, "
        f"{len(failed)} outside the limits")
    if failed:
        raise AssertionError(f"mechanism reference: card and CPU disagree: {failed}")


def free_hunch_tests(op, res: int, cap: int, prior_dir: str):
    """The mechanism configuration of the CPU parity tests
    (tests/test_torch_freehunch.py): the DCT prior cut to the 32 px grid,
    vjp guidance, CG recycling the previous stage's solution."""
    return choose_conditioning_mechanism("online_covariance")(
        cond_scaling=1.0, forward_operator=op, image_base_covariance="dct_diagonal",
        data_dir=prior_dir, init_denoiser_variance=1.0, init_noise_variance=80.0**2,
        data_dim=3 * res * res, cov_capacity=cap, solver_type="customcuda",
        cg_coords="pixel", cg_warm_start="prev", guidance_gradient="vjp")


def rel_rms(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# Fixed limits of the 32 px int8 references, card against CPU, as relative
# RMS differences. PERF.md (section 6, PR 2) gives each one's sound reading
# and the readings of wrong paths, from tests/test_torch_chip_smoke_int8.py.
# Every int8 module on its own, replayed on the card's recorded inputs:
# only K2's ties can move a code, so a sound path reads near 0 and a wrong
# quantiser, scale or FiLM fold 1e-2 or more.
INT8_MODULE_LIMITS = dict(out_rel_rms=2e-3, dx_rel_rms=2e-3)
# The whole torso and 3 guided Heun steps: one code that flips at a rounding
# tie moves the per-sample abs-max and with it every later code, so a
# 1e-6 change of the input alone moves these by 1-7 %. They catch a wrong
# pullback, a lost calibration or non-finite output, not a subtle error.
INT8_REF_LIMITS = dict(unet_rel_rms=5e-2, step_rel_rms=(5e-2, 5e-2, 0.2),
                       table_rel_max=5e-2)


class Int8Reference:
    """The 32 px int8 witness: seeded weights of the tiny UNet (f32 torso),
    noise and measurement; the bench's Heun solver, 3 steps; the DCT prior
    of the CPU parity tests cut to 32 px, written to ``prior_dir``."""

    res, batch, steps = 32, 2, 3

    def __init__(self, seed: int, prior_dir: str):
        res, batch = self.res, self.batch
        self.tiny = dict(TINY, dtype=torch.float32)
        self.state = loading.random_init_(create_model(**self.tiny, quant="int8"),
                                          seed=seed).state_dict()
        rng = np.random.default_rng(seed + 1)
        self.noise = rng.normal(size=(batch, 3, res, res)).astype(np.float32)
        self.y = rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32)
        pre0 = IDDPMLinearPrecond(torch.nn.Identity(), img_resolution=res, img_channels=3)
        self.xs, self.s0 = schedule(pre0, self.steps)
        self.cap = edm.required_cov_capacity(self.xs)
        self.sig0 = float(self.xs["sigma_hat"][0])
        # the raw UNet's input at the first guided call
        self.c_in = np.float32(self.s0 / np.sqrt(self.sig0 ** 2 + 1.0))
        self.t_in = torch.full((batch,), float(pre0.M - pre0.round_sigma(self.sig0, True)))
        self.prior_dir = prior_dir
        prior = assets.dct_variance()[:, :res, :res] / (256 // res) ** 2
        np.savez(Path(prior_dir) / "dct_variance.npz", dct_variance=prior.astype(np.float32))

    def run(self, quant: str, fused: bool, dev: str, noise=None) -> dict:
        """One side: the static torso calibrates its own table first; then
        the guided Heun slice, and the raw UNet on the first guided call's
        input (a static torso on the stage of its table that call selects).
        Returns the trajectory, CG niter, the raw UNet's output, the table
        and the kernel launches of the side. ``noise`` replaces the seeded
        noise (the UNet's input follows it)."""
        res = self.res
        with torch.device(dev):
            model = create_model(**self.tiny, quant=quant, fused_gn_quant=fused)
        model.load_state_dict(self.state)
        model.eval().requires_grad_(False)
        op = get_operator("gaussian_blur", in_shape=(1, 3, res, res), sigma_s=0.1, device=dev)
        noise = self.noise if noise is None else noise
        nz, yy = torch.as_tensor(noise, device=dev), torch.as_tensor(self.y, device=dev)
        zero_counts()
        qs = None
        if quant == "int8_static":
            qs = calibrate_qscales(TINY, self.state, free_hunch_tests(op, res, self.cap,
                                                                      self.prior_dir),
                                   nz, yy, self.xs, self.s0, dtype=torch.float32, device=dev)
        precond = loading.wrap_precond(model, {"image_size": res}, qscales=qs)
        _, traj, diag = edm.sample_loop(
            precond, free_hunch_tests(op, res, self.cap, self.prior_dir), nz, yy, self.xs,
            sigma0_scaled=self.s0, return_trajectory=True, collect_diagnostics=True)
        with torch.no_grad():
            precond(torch.zeros_like(nz), self.sig0)     # a static torso's stage
            f = model(nz * float(self.c_in), self.t_in.to(dev))
        return dict(traj=traj.cpu().numpy(), niter=diag["cg_niter"].numpy(),
                    unet=f.cpu().numpy(), launches=counts(), qs=qs, model=model)

    def unet_input(self, dev: str):
        return (torch.as_tensor(self.noise * self.c_in, device=dev), self.t_in.to(dev))

    def readings(self, cpu: dict, card: dict) -> dict:
        """card against cpu: the raw UNet's and every Heun step's relative
        RMS difference (and max |d| over max |ref|, printed only), CG niter,
        and a static torso's calibrated tables."""
        out = {}
        if cpu["qs"] is not None:
            qc, qg = cpu["qs"], card["qs"]
            out["table_rel_max"] = max(float(np.max(np.abs(qg[1][k] - qc[1][k]) / qc[1][k]))
                                       for k in qc[1])
            out["same_grid"] = bool(np.array_equal(qg[0], qc[0]))
        f_cpu, f_card = cpu["unet"], card["unet"]
        out["unet_rel_rms"] = rel_rms(f_card, f_cpu)
        out["unet_max"] = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
        out["step_rel_rms"] = [rel_rms(card["traj"][i], cpu["traj"][i])
                               for i in range(self.steps)]
        out["step_max"] = [float(np.abs(card["traj"][i] - cpu["traj"][i]).max()
                                 / np.abs(cpu["traj"][i]).max()) for i in range(self.steps)]
        out["niter_cpu"], out["niter_card"] = cpu["niter"].tolist(), card["niter"].tolist()
        out["finite"] = bool(np.isfinite(card["traj"]).all() and np.isfinite(f_card).all())
        return out


def int8_module_inputs(model, x, t) -> list:
    """(name, input, gn) of every int8 module call in one forward of
    ``model``, on its device; ``gn`` the fused route's (gamma, beta) or None."""
    recs = []

    def hook(name):
        def rec(mod, args, kwargs, out):
            gn = kwargs.get("gn")
            recs.append((name, args[0].detach().clone(),
                         None if gn is None else tuple(g.detach().clone() for g in gn)))
        return rec
    hooks = [m.register_forward_hook(hook(n), with_kwargs=True)
             for n, m in model.named_modules() if isinstance(m, (q.QuantConv, q.QuantDense))]
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return recs


def int8_module_replay(model, recs: list) -> list:
    """Each recorded call again, on ``model``'s device: (output, input
    gradient under a seeded cotangent), as f32 CPU arrays."""
    dev = next(model.parameters()).device
    out = []
    for i, (name, x, gn) in enumerate(recs):
        xd = x.to(dev).requires_grad_(True)
        kw = {} if gn is None else {"gn": tuple(g.to(dev) for g in gn)}
        y = model.get_submodule(name)(xd, **kw)
        ct = np.random.default_rng(i).normal(size=tuple(y.shape)).astype(np.float32)
        (dx,) = torch.autograd.grad(y, xd, torch.as_tensor(ct, device=dev).to(y.dtype))
        out.append((y.detach().float().cpu().numpy(), dx.float().cpu().numpy()))
    return out


def int8_module_readings(recs: list, cpu: list, card: list) -> dict:
    """The largest relative RMS difference, card against CPU, of any int8
    module's output and of its input gradient, with the module's name."""
    out_rel = [(rel_rms(g[0], c[0]), r[0]) for r, c, g in zip(recs, cpu, card)]
    dx_rel = [(rel_rms(g[1], c[1]), r[0]) for r, c, g in zip(recs, cpu, card)]
    return dict(modules=len(recs), fused=sum(r[2] is not None for r in recs),
                out_rel_rms=max(out_rel), dx_rel_rms=max(dx_rel))


def int8_reference_failures(r: dict, m: dict) -> list:
    """What the slice readings ``r`` and the module readings ``m`` break of
    the limits and of equal CG niter."""
    lim, bad = INT8_REF_LIMITS, []
    if not r["finite"]:
        bad.append("card output not finite")
    if r["niter_card"] != r["niter_cpu"]:
        bad.append("CG niter differs")
    if not r["unet_rel_rms"] <= lim["unet_rel_rms"]:
        bad.append(f"raw UNet rel RMS {r['unet_rel_rms']:.3g} > {lim['unet_rel_rms']}")
    for i, (e, cap) in enumerate(zip(r["step_rel_rms"], lim["step_rel_rms"])):
        if not e <= cap:
            bad.append(f"Heun step {i} rel RMS {e:.3g} > {cap}")
    if "table_rel_max" in r and not (r["same_grid"]
                                     and r["table_rel_max"] <= lim["table_rel_max"]):
        bad.append(f"calibrated tables: grid equal {r['same_grid']}, max rel "
                   f"{r['table_rel_max']:.3g} > {lim['table_rel_max']}")
    for key, cap in INT8_MODULE_LIMITS.items():
        if not m[key][0] <= cap:
            bad.append(f"module {m[key][1]}: {key} {m[key][0]:.3g} > {cap}")
    return bad


def int8_reference_phase(seed: int, card: str = "cuda"):
    """32 px int8 torsos, f32, card (K1-K3) vs CPU (plain versions): the
    fused route, then the static torso with a calibration on each side.
    Each is held to ``INT8_MODULE_LIMITS`` module by module (the card's
    int8 modules recorded in one forward of the raw UNet, then each call
    replayed on both devices, forward and pullback; the static modules on
    the CPU's scales) and to ``INT8_REF_LIMITS`` end to end (the raw UNet,
    3 guided Heun steps with equal CG niter, the calibrated tables)."""
    with tempfile.TemporaryDirectory() as prior_dir:
        ref = Int8Reference(seed, prior_dir)
        for label, quant, fused in (("fused int8", "int8", True),
                                    ("static int8", "int8_static", False)):
            cpu, gpu = ref.run(quant, fused, "cpu"), ref.run(quant, fused, card)
            want_kernels = ("int8_conv",) + (("gn_silu_quant",) if fused else ())
            if any(cpu["launches"].values()) or not all(gpu["launches"][k]
                                                        for k in want_kernels):
                raise AssertionError(f"{label} reference: launches cpu {cpu['launches']}, "
                                     f"card {gpu['launches']}")
            r = ref.readings(cpu, gpu)
            for name, mod in cpu["model"].named_modules():
                if isinstance(mod, q._QuantSite):
                    gpu["model"].get_submodule(name).act_scale.copy_(mod.act_scale)
            recs = int8_module_inputs(gpu["model"], *ref.unet_input(card))
            m = int8_module_readings(recs, int8_module_replay(cpu["model"], recs),
                                     int8_module_replay(gpu["model"], recs))
            lim = INT8_REF_LIMITS
            say(f"reference 32 px {label}, card vs CPU: {m['modules']} int8 module calls "
                f"({m['fused']} fused) replayed on the card's inputs, largest rel RMS "
                f"output {m['out_rel_rms'][0]:.4g} ({m['out_rel_rms'][1]}), input gradient "
                f"{m['dx_rel_rms'][0]:.4g} ({m['dx_rel_rms'][1]}) (limits "
                f"{INT8_MODULE_LIMITS}); raw UNet rel RMS {r['unet_rel_rms']:.4g} (limit "
                f"{lim['unet_rel_rms']}; max |dF| {r['unet_max']:.4g} of max |F|); 3 Heun "
                f"steps, rel RMS {[round(e, 6) for e in r['step_rel_rms']]} (limits "
                f"{list(lim['step_rel_rms'])}; max |dx| "
                f"{[round(e, 6) for e in r['step_max']]} of max |x|); CG niter card "
                f"{r['niter_card']} cpu {r['niter_cpu']}"
                + (f"; calibrated scales max rel {r['table_rel_max']:.4g} (limit "
                   f"{lim['table_rel_max']})" if "table_rel_max" in r else "")
                + f"; card launches {gpu['launches']}")
            bad = int8_reference_failures(r, m)
            if bad:
                raise AssertionError(f"{label} reference: card and CPU disagree: {bad}")


KERNEL_FAMILIES = (
    ("K3 int8_conv and its split-K epilogue (csrc/int8_conv.cu)", ("int8_conv",)),
    ("K2 gn_silu_quant finalize, amax, quantise (csrc/gn_quant.cu)", ("gnq_",)),
    ("K1a/K2a GroupNorm statistics (csrc/gn_stats.cuh)", ("gn_stats", "gn_finalize")),
    ("K1/K2 one-launch cluster path (csrc/gn_cluster.cuh)", ("gn_cluster",)),
    ("K1b groupnorm_silu apply (csrc/groupnorm.cu)", ("gn_apply",)),
    ("cuFFT", ("fft",)),
    ("convolutions and matmuls (cuDNN, cuBLAS)",
     ("gemm", "xmma", "conv", "cutlass", "cudnn", "implicit")),
    ("softmax", ("softmax",)))
# the profiler ranges of the plain-autograd backwards (ops/groupnorm.py, ops/quant.py)
RANGES = ("groupnorm_silu_backward", "gn_quant_conv_backward")


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
        if e.device_type != DeviceType.CUDA or e.key in RANGES:
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


def backward_share(guided_call, calls_per_run: int, run_busy_us: float, range_name: str):
    """One guided call (forward, vjp, covariance and CG) under
    ``torch.profiler`` with host and device activity: the device time of
    the kernels launched inside the ``range_name`` ranges, as a share of the
    call's device time and, times the calls of a run, of the profiled run's
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        guided_call()
        torch.cuda.synchronize()
    events = prof.events()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and e.name not in RANGES)
    ranges = [e for e in events
              if e.device_type == DeviceType.CPU and e.name == range_name]
    bwd = sum(e.device_time_total for e in ranges)
    if busy <= 0 or not ranges:
        raise AssertionError(f"backward attribution: {len(ranges)} {range_name} ranges, "
                             f"{busy} us of device time in the trace")
    say(f"  one guided call traced: device {busy / 1e3:.3f} ms, of which "
        f"{len(ranges)} {range_name} ranges {bwd / 1e3:.3f} ms "
        f"({bwd / busy:.3f}); x {calls_per_run} calls = {bwd * calls_per_run / 1e6:.3f}"
        f" s, {bwd * calls_per_run / run_busy_us:.3f} of the profiled run's device time")


def expected_launches(model, fw: int, calls: dict) -> dict:
    """Each kernel's launches over a run that made ``fw`` guided calls, from
    the module calls the hooks counted (``calls``: GroupNorm32 calls, fused
    QuantConv calls, all int8 module calls, recomputes included): K1 once
    per GroupNorm call, K2 once per fused call, K3 once per int8 module call
    and once more per int8 module in each call's vjp (the pullback)."""
    n_int8 = sum(isinstance(m, (q.QuantConv, q.QuantDense)) for m in model.modules())
    return {"groupnorm_silu": calls["gn"], "gn_silu_quant": calls["fused"],
            "int8_conv": calls["int8"] + fw * n_int8}


def slice_operator(name: str, res: int, dev, seed: int):
    """The bench's operators at sigma_s 0.1: the 61x61 gaussian blur (std
    3), bicubic super-resolution x4, or inpainting with one random mask
    (p ~ U(0.1, 0.3), ``eval.py``'s defaults) drawn from a seeded CPU
    generator."""
    kw = dict(in_shape=(1, 3, res, res), sigma_s=0.1, device=dev)
    if name == "gaussian_blur":
        kw.update(kernel_size=61, intensity=3.0)
    elif name == "super_resolution":
        kw.update(scale_factor=4)
    elif name == "inpainting":
        kw.update(mask_opt={"mask_type": "random", "image_size": res,
                            "mask_prob_range": (0.1, 0.3)},
                  mask_generator=torch.Generator().manual_seed(seed))
    return get_operator(name, **kw)


def slice_phase(model, model_args, batch: int, steps: int, runs: int, seed: int,
                label: str, op_name: str = "gaussian_blur", profile: bool = True):
    """The bench.py protocol on ``model`` and the operator ``op_name``
    (with ``profile``, one more run under the profiler); returns the first
    run's launch counts and the wall time of every run."""
    dev = next(model.parameters()).device
    res = model_args["image_size"]
    precond = loading.wrap_precond(model, model_args)
    op = slice_operator(op_name, res, dev, seed)
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

    calls = Counter()

    def count_gn(mod, args):
        calls["gn"] += 1

    def count_int8(mod, args, kwargs):
        calls["int8"] += 1
        calls["fused"] += kwargs.get("gn") is not None

    hooks = [m.register_forward_pre_hook(count_gn) for m in model.modules()
             if isinstance(m, GroupNorm32)]
    hooks += [m.register_forward_pre_hook(count_int8, with_kwargs=True)
              for m in model.modules() if isinstance(m, (q.QuantConv, q.QuantDense))]
    say(f"{label} slice: {res}x{res}, batch {batch}, {steps} Heun steps, cov_capacity "
        f"{cap}, {sum(p.numel() for p in model.parameters())} parameters")
    if op_name != "gaussian_blur":
        say(f"  {op_name}: measurement y {tuple(y.shape)}"
            + (f", observed pixels {float(op.mask[0, 0].mean()):.4f}"
               if op_name == "inpainting" else ""))
    walls = []
    for run in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if run == 0:
            forwards = 0
            calls.clear()
            zero_counts()
        t0 = time.perf_counter()
        x, _, diag = edm.sample_loop(denoise, mech, noise, y, xs, gen,
                                     sigma0_scaled=s0, collect_diagnostics=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            launches = counts()
            counted = dict(forwards=forwards, calls=dict(calls), diag=diag,
                           rank=mech.state.cov.k.cpu().tolist(), x=x)
        say(f"  run {run}: wall {walls[-1]:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for h in hooks:
        h.remove()
    busy = profile and device_breakdown(lambda: edm.sample_loop(denoise, mech, noise, y, xs,
                                                                gen, sigma0_scaled=s0))
    fused = counted["calls"].get("fused", 0)
    if busy:
        fh = mech.mech
        backward_share(lambda: fh(denoise, noise * s0, y, float(xs["sigma_hat"][0]),
                                  fh.init_state(batch, (3, res, res))),
                       counted["forwards"], busy,
                       RANGES[1] if fused else RANGES[0])

    x, diag = counted["x"], counted["diag"]
    if tuple(x.shape) != (batch, 3, res, res) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{label} slice: final x {tuple(x.shape)} not finite")
    fw = counted["forwards"]
    want = expected_launches(model, fw, Counter(counted["calls"]))
    in_resblocks = sum(isinstance(m, GroupNorm32) for r in model.modules()
                       if isinstance(r, ResBlock) and not r.fused for m in r.modules())
    n_norms = sum(isinstance(m, GroupNorm32) for m in model.modules()) - sum(
        2 * r.fused for r in model.modules() if isinstance(r, ResBlock))
    say(f"  launches {launches} over {fw} guided calls; from the module hooks "
        f"{want}; per guided call: " + ", ".join(
            f"{k} {v / max(fw, 1):g}" for k, v in launches.items()))
    if fw != 2 * steps - 1 or launches != want:
        raise AssertionError(f"{label} slice: launches {launches}, hooks say {want} "
                             f"over {fw} forwards")
    if launches["groupnorm_silu"] != fw * (n_norms + in_resblocks):
        raise AssertionError(f"{label} slice: {launches['groupnorm_silu']} K1 launches, "
                             f"topology says {fw} x ({n_norms} + {in_resblocks})")
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


class TimedMechanism:
    """Pass-through guidance mechanism that records each call's wall ms (the
    card synchronised on both sides) and K1 launches."""

    def __init__(self, mech):
        self.mech, self.calls = mech, []

    def init_state(self, batch, img_shape):
        return self.mech.init_state(batch, img_shape)

    def __call__(self, denoise, x_t, y, sigma, state):
        torch.cuda.synchronize()
        t0, k1 = time.perf_counter(), gn.launches
        out = self.mech(denoise, x_t, y, sigma, state)
        torch.cuda.synchronize()
        self.calls.append(((time.perf_counter() - t0) * 1e3, gn.launches - k1))
        return out


def sweep_phase(model, model_args, batch: int, steps: int, seed: int):
    """The seven mechanisms besides Free Hunch on the three operators at
    full width: one short run each, with every guided call's wall ms and
    K1 launches; any call without a K1 launch or a non-finite sample
    raises."""
    dev = next(model.parameters()).device
    res = model_args["image_size"]
    precond = loading.wrap_precond(model, model_args)
    xs, s0 = schedule(precond, steps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    truth = torch.rand((batch, 3, res, res), generator=gen, device=dev) * 2 - 1
    noise = torch.randn((batch, 3, res, res), generator=gen, device=dev)
    say(f"mechanism sweep: {res}x{res}, batch {batch}, {steps} Heun steps (wall ms and K1 "
        f"launches per guided call)")
    t_all = time.perf_counter()
    for op_name in MECH_OPS:
        op = slice_operator(op_name, res, dev, seed)
        y = op.forward(truth, generator=gen)
        for name in MECHANISMS[1:]:
            mech = TimedMechanism(mechanism(name, op, res, 0))
            x, _ = edm.sample_loop(precond, mech, noise, y, xs, sigma0_scaled=s0)
            ms = [round(c[0], 1) for c in mech.calls]
            k1 = [c[1] for c in mech.calls]
            say(f"  {name} on {op_name}: {ms} ms, K1 {k1}")
            if not (bool(torch.isfinite(x).all()) and all(k1)):
                raise AssertionError(f"sweep {name} on {op_name}: finite "
                                     f"{bool(torch.isfinite(x).all())}, K1 launches {k1}")
    say(f"mechanism sweep: {len(MECH_OPS) * (len(MECHANISMS) - 1)} runs in "
        f"{time.perf_counter() - t_all:.1f} s")


def cg_coords_phase(batch: int, seed: int, res: int, dev, iters=(10, 40)):
    """Host-clock time of one deblur CG iteration in pixel and in Fourier
    coordinates on the same system (the gaussian blur, the bundled DCT
    prior as the covariance, its spectral preconditioner), from two solves
    of fixed lengths that never converge (rtol 0): the difference over the
    difference of iterations. Changes nothing; ``cg_coords='auto'`` takes
    pixel on the card."""
    from free_hunch_tpu_torch.ops.dct import dct_2d, idct_2d
    op = slice_operator("gaussian_blur", res, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.rand((batch, 3, res, res), generator=gen, device=dev) * 2 - 1
    y = op.forward(torch.rand_like(x0) * 2 - 1, generator=gen)
    prior = torch.as_tensor(assets.dct_variance()[:, :res, :res], device=dev)[None]
    spec = solvers._dct_spec_to_fourier(prior.expand(batch, -1, -1, -1))

    def cov_mv(v):
        return idct_2d(prior * dct_2d(v))

    per_iter = {}
    for label, fn in (("pixel", solvers.deblur_mat_cg),
                      ("fourier", solvers.deblur_mat_cg_fourier)):
        timed = []
        for n in (iters[0],) + tuple(iters):       # the first solve warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = fn(op, y, x0, cov_mv=cov_mv, rtol=0.0, maxiter=n, return_info=True,
                         warm_start=True, min_iter=1, stall_iters=10**6,
                         cov_fourier_spec=spec)
            torch.cuda.synchronize()
            timed.append((info.niter, time.perf_counter() - t0))
        (n1, t1), (n2, t2) = timed[1:]
        if n2 <= n1:
            raise AssertionError(f"CG coordinates {label}: {n1} and {n2} iterations")
        per_iter[label] = (t2 - t1) / (n2 - n1) * 1e3
        say(f"CG coordinates, {label}: {n1} iterations {t1:.4f} s, {n2} iterations "
            f"{t2:.4f} s -> {per_iter[label]:.3f} ms per iteration (batch {batch}, {res} px)")
    say(f"CG coordinates: fourier / pixel = {per_iter['fourier'] / per_iter['pixel']:.3f} "
        f"per iteration")
    return per_iter


def mechanism_phases(model, model_args, args) -> dict:
    """Phases 4b-4d on the bf16 model; returns the new slices' launches."""
    out = {}
    for op_name in ("super_resolution", "inpainting"):
        launches, walls = slice_phase(model, model_args, args.batch, args.steps, 1, args.seed,
                                      f"bf16 {op_name}", op_name=op_name, profile=False)
        say(f"bf16 {op_name} sampling wall time per run (s): {[round(w, 3) for w in walls]}")
        out[op_name] = launches
        torch.cuda.empty_cache()
    sweep_phase(model, model_args, 2, 3, args.seed)
    cg_coords_phase(args.batch, args.seed, model_args["image_size"],
                    next(model.parameters()).device)
    return out


# -- phases 3c and 4e: DDNM+, and Free Hunch in f64 and on the cosine grid ----

DDNM_OPS = ("gaussian_blur", "super_resolution", "inpainting")
# each step's x_next on the card within this share of its own max |x|
DDNM_REF_STEP_REL = 1e-3
DDNM_MASK = {"mask_type": "random", "mask_prob_range": (0.1, 0.3)}


def ddnm_operator(name: str, res: int, dev, seed: int, rows: int = 0):
    """The DDNM+ operators: ``Deblurring`` of the bundled 61x61 gaussian
    kernel, block super-resolution x4, or inpainting with a random mask
    (p ~ U(0.1, 0.3), ``eval.py``'s defaults) drawn from a seeded CPU
    generator: shared by the batch, or with ``rows`` the per-row operator
    of that mask repeated ``rows`` times."""
    if name == "gaussian_blur":
        return ddnm.build_svd_operator({"name": name}, res, device=dev)
    if name == "super_resolution":
        return ddnm.build_svd_operator({"name": name, "scale_factor": 4}, res, device=dev)
    gen = torch.Generator().manual_seed(seed)
    opt = dict(DDNM_MASK, image_size=res)
    if rows:
        return svd.create_inpainting_operator(3, res, opt, generator=[gen], repeats=rows,
                                              device=dev)
    return svd.create_inpainting_operator(3, res, opt, generator=gen, device=dev)


class DDNMReference:
    """The 32 px witness of DDNM+: seeded weights of the tiny f32 UNet,
    noise, a ground truth measured once on the CPU by each operator with
    sigma_y 0.1 noise, and every step's ancestral draw (``noise_seq``);
    eta 1.0 on a 10-step DDPM grid.

    The CPU runs the sampler; the card runs each step from the CPU's x_t
    (teacher forcing) and each step's x_next is compared. Compared along
    the whole trajectory instead, Eq. 12's division of epsilon's error by
    sqrt(alpha-bar) (about 85 at the first step here, 160 on a 60-step
    grid) would carry one step's rounding into every later step."""

    res, batch, steps, sigma_y, eta = 32, 2, 10, 0.1, 1.0

    def __init__(self, seed: int):
        res, batch = self.res, self.batch
        self.seed = seed
        self.tiny = dict(TINY, dtype=torch.float32)
        self.state = loading.random_init_(create_model(**self.tiny), seed=seed).state_dict()
        rng = np.random.default_rng(seed + 3)
        self.noise = rng.normal(size=(batch, 3, res, res)).astype(np.float32)
        self.truth = rng.uniform(-1, 1, (batch, 3 * res * res)).astype(np.float32)
        n = len(ddnm.ddnm_steps(self.steps))
        self.noise_seq = rng.normal(size=(n, batch, 3, res, res)).astype(np.float32)
        self.y_noise = rng.normal(size=(batch, 3 * res * res)).astype(np.float32)
        self.models, self.ys = {}, {}

    def eps_fn(self, dev, nudge: float = 0.0):
        """The raw UNet's epsilon channels; ``nudge`` multiplies them by
        (1 + nudge N(0, 1)), a stand-in for another device's rounding."""
        if dev not in self.models:
            with torch.device(dev):
                model = create_model(**self.tiny)
            model.load_state_dict(self.state)
            self.models[dev] = model.eval().requires_grad_(False)
        model = self.models[dev]
        rng = np.random.default_rng(1)

        def eps(x, t):
            e = model(x, t)[:, :3]
            if nudge:
                e = e * (1 + nudge * torch.as_tensor(rng.normal(size=tuple(e.shape)),
                                                     dtype=e.dtype, device=e.device))
            return e
        return eps

    def run(self, op_name: str, dev: str, teacher=None, nudge: float = 0.0) -> dict:
        """One side: each step's x_next and the K1 launches. Without
        ``teacher`` the sampler runs; with it (the CPU side's result) each
        of its steps runs again here from its x_t."""
        a_funcs = ddnm_operator(op_name, self.res, dev, self.seed)
        if op_name not in self.ys:
            cpu_op = ddnm_operator(op_name, self.res, "cpu", self.seed)
            y = cpu_op.A(torch.as_tensor(self.truth))
            self.ys[op_name] = y + self.sigma_y * torch.as_tensor(self.y_noise[:, :y.shape[1]])
        y = self.ys[op_name].to(dev)
        eps = self.eps_fn(dev, nudge)
        seq = torch.as_tensor(self.noise_seq, device=dev)
        before = gn.launches
        sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            if teacher is None:
                x, traj = ddnm.ddnm_sample(eps, a_funcs, torch.as_tensor(self.noise, device=dev),
                                           y, num_steps=self.steps, sigma_y=self.sigma_y,
                                           eta=self.eta, return_trajectory=True, noise_seq=seq)
                x_next = [t.cpu().numpy() for t in traj]
            else:
                steps = ddnm.ddnm_steps(self.steps)
                xts = [self.noise] + teacher["x_next"][:-1]
                x_next = []
                for i, (st, xt) in enumerate(zip(steps, xts)):
                    xt = torch.as_tensor(xt, device=dev)
                    nxt, _ = ddnm.ddnm_step(eps, a_funcs, y, xt, torch.zeros_like(xt), st,
                                            seq[i], sigma_y=self.sigma_y, eta=self.eta)
                    x_next.append(nxt.cpu().numpy())
        sync(dev)
        return dict(x_next=x_next, launches=gn.launches - before,
                    wall_s=time.perf_counter() - t0)


def ddnm_reference_failures(cpu: dict, card: dict) -> tuple:
    """(per-step max |dx|, per-step limit, what breaks the limits) of one
    DDNM+ case, card against CPU."""
    want, got = cpu["x_next"], card["x_next"]
    limit = np.array([DDNM_REF_STEP_REL * np.abs(w).max() for w in want])
    err = np.array([np.abs(g - w).max() for g, w in zip(got, want)])
    bad = []
    if len(got) != len(want) or not all(np.isfinite(g).all() for g in got):
        bad.append("card output not finite or missing steps")
    bad += [f"step {i} max |dx| {e:.3g} > {lim:.3g}"
            for i, (e, lim) in enumerate(zip(err, limit)) if not e <= lim]
    return err, limit, bad


def ddnm_reference_phase(seed: int, card: str = "cuda"):
    """Phase 3c: DDNM+ per step on the three operators, and Free Hunch with
    f64 algebra and through the cosine preconditioner per guided call
    (phase 3b's limits and equal CG niter), card (K1) against CPU (plain
    version); the f64 run's wall time beside the f32 one's. Any case
    outside its limits or without K1 launches on the card raises."""
    failed = []
    t0 = time.perf_counter()
    ref = DDNMReference(seed)
    for op in DDNM_OPS:
        cpu = ref.run(op, "cpu")
        gpu = ref.run(op, card, teacher=cpu)
        err, limit, bad = ddnm_reference_failures(cpu, gpu)
        if cpu["launches"] != 0 or gpu["launches"] == 0:
            bad.append(f"K1 launches cpu {cpu['launches']} card {gpu['launches']}")
        say(f"DDNM+ reference 32 px on {op}, card vs CPU, per step: max |dx| "
            f"{[float(f'{e:.3g}') for e in err]} (limits "
            f"{[float(f'{v:.3g}') for v in limit]}), card K1 launches {gpu['launches']}"
            + (f"; FAILS: {bad}" if bad else ""))
        if bad:
            failed.append(("ddnm", op, bad))
    mref = MechanismReference(seed)
    walls = {}
    for mech, op in (("online_covariance", "gaussian_blur"),) + FH_VARIANT_CASES:
        cpu = mref.run(mech, op, "cpu")
        gpu = mref.run(mech, op, card, teacher=cpu)
        if op == "gaussian_blur" and mech in ("online_covariance", "online_covariance_f64"):
            # the first run on the card carries its warm-up: time two more
            walls[mech] = [mref.run(mech, op, card, teacher=cpu)["wall_s"] for _ in range(2)]
        err, limit, bad = mechanism_reference_failures(cpu, gpu)
        if cpu["launches"] != 0 or gpu["launches"] == 0:
            bad.append(f"K1 launches cpu {cpu['launches']} card {gpu['launches']}")
        say(f"Free Hunch reference 32 px {mech} on {op}, card vs CPU, per guided call: max "
            f"|dx0| {[float(f'{e:.3g}') for e in err]} (limits "
            f"{[float(f'{v:.3g}') for v in limit]}), CG niter "
            f"{[c['niter'] for c in gpu['calls']]}, card wall {gpu['wall_s']:.3f} s"
            + (f"; FAILS: {bad}" if bad else ""))
        if bad:
            failed.append((mech, op, bad))
    say(f"Free Hunch on gaussian_blur, 5 guided calls on the card from the CPU's state, "
        f"two warm runs each: f32 algebra {walls['online_covariance']} s, f64 algebra "
        f"{walls['online_covariance_f64']} s of wall time")
    say(f"DDNM+ and Free Hunch variant reference: {len(DDNM_OPS) + len(FH_VARIANT_CASES)} "
        f"cases in {time.perf_counter() - t0:.1f} s, {len(failed)} outside the limits")
    if failed:
        raise AssertionError(f"DDNM+ / Free Hunch variant reference: card and CPU disagree: "
                             f"{failed}")


def ddnm_phase(model, model_args, batch: int, steps: int, seed: int) -> dict:
    """Phase 4e: DDNM+ through the raw 256 px UNet on the DDPM grid (sigma_y
    0.1, eta 1.0) on the three operators, inpainting through the per-row
    operator: wall time, peak memory, the final sample, ||A x - y|| / ||y||
    and K1's launches against the hooks' count of GroupNorm32 calls, read
    over each run; the gaussian blur's run once more under the profiler.
    Returns each operator's K1 launches."""
    dev = next(model.parameters()).device
    res = model_args["image_size"]
    calls = Counter()

    def count_gn(mod, args):
        calls["gn"] += 1

    hooks = [m.register_forward_pre_hook(count_gn) for m in model.modules()
             if isinstance(m, GroupNorm32)]

    def eps_fn(x, t):
        return model(x, t)[:, :3]

    out = {}
    say(f"DDNM+ slices: {res}x{res}, batch {batch}, {steps} steps, sigma_y 0.1, eta 1.0, "
        f"the raw UNet on the DDPM grid")
    try:
        for op_name in DDNM_OPS:
            a_funcs = ddnm_operator(op_name, res, dev, seed, rows=batch)
            gen = torch.Generator(device=dev).manual_seed(seed)
            truth = torch.rand((batch, 3 * res * res), generator=gen, device=dev) * 2 - 1
            with torch.no_grad():
                y = a_funcs.A(truth)
            y = y + 0.1 * torch.randn(y.shape, generator=gen, device=dev)
            noise = torch.randn((batch, 3, res, res), generator=gen, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            calls.clear()
            zero_counts()
            t0 = time.perf_counter()
            x, _ = ddnm.ddnm_sample(eps_fn, a_funcs, noise, y, num_steps=steps, sigma_y=0.1,
                                    eta=1.0, generator=gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts()
            with torch.no_grad():
                resid = float(torch.linalg.norm(a_funcs.A(x.reshape(batch, -1)) - y)
                              / torch.linalg.norm(y))
            finite = bool(torch.isfinite(x).all())
            say(f"  DDNM+ {op_name}: wall {wall:.3f} s, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, y {tuple(y.shape)}, "
                f"final x finite {finite} shape {tuple(x.shape)} mean {float(x.mean()):.4f} "
                f"std {float(x.std()):.4f}, ||A x - y|| / ||y|| {resid:.4f}, K1 launches "
                f"{launches['groupnorm_silu']} (hooks: {calls['gn']} GroupNorm32 calls, "
                f"{launches['groupnorm_silu'] / steps:g} per step)")
            if not finite or tuple(x.shape) != (batch, 3, res, res) or not np.isfinite(resid):
                raise AssertionError(f"DDNM+ {op_name}: final x {tuple(x.shape)} finite "
                                     f"{finite}, residual {resid}")
            if not 0 < launches["groupnorm_silu"] == calls["gn"]:
                raise AssertionError(f"DDNM+ {op_name}: {launches['groupnorm_silu']} K1 "
                                     f"launches, hooks say {calls['gn']}")
            out[op_name] = launches["groupnorm_silu"]
            if op_name == DDNM_OPS[0]:
                device_breakdown(lambda: ddnm.ddnm_sample(
                    eps_fn, a_funcs, noise, y, num_steps=steps, sigma_y=0.1, eta=1.0,
                    generator=gen))
            del a_funcs, x, y
            torch.cuda.empty_cache()
    finally:
        for h in hooks:
            h.remove()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--runs", type=int, default=2, help="sampling runs of the bf16 "
                    "slice; the first is counted, every one is timed (the int8 slice "
                    "runs once)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k3", action="store_true", help="K3 alone: host and device time of "
                    "one call, and every cut of the small layers; no model, no result lines")
    ap.add_argument("--gn", action="store_true", help="K1 and K2 alone: per call and per "
                    "pass at every distinct shape of one forward; no slice, no result lines")
    ap.add_argument("--mechanisms", action="store_true", help="the mechanism reference, the "
                    "SR and inpainting slices, the sweep and the CG-coordinates reading alone; "
                    "no result lines")
    ap.add_argument("--ddnm", action="store_true", help="phases 3c and 4e alone: the DDNM+ "
                    "and Free Hunch variant reference and the 256 px DDNM+ slices; no result "
                    "lines")
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

    t_start = time.perf_counter()
    smi = card_facts()
    if args.k3:
        k3_phase()
        say(f"chip_smoke --k3 wall time {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args.gn:
        gn_phase(args.batch, args.seed)
        say(f"chip_smoke --gn wall time {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    t0 = time.perf_counter()
    model, model_args = loading.load_model(
        str(CKPT_256), str(SETUP_256), dtype=torch.bfloat16,
        init_random_if_missing=True, rng_seed=args.seed, remat=True)
    torch.cuda.synchronize()
    say(f"256 px UNet built ({'checkpoint' if CKPT_256.exists() else 'seeded random'}"
        f" weights) in {time.perf_counter() - t0:.2f} s")
    if args.mechanisms:
        mechanism_reference_phase(args.seed)
        mechanism_phases(model, model_args, args)
        say(f"chip_smoke --mechanisms wall time {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args.ddnm:
        ddnm_reference_phase(args.seed)
        ddnm_phase(model, model_args, args.batch, 2 * args.steps, args.seed)
        say(f"chip_smoke --ddnm wall time {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    res = model_args["image_size"]
    gn_entry = gn_kernel_phase(gn_shapes_of_forward(model, args.batch, res, "cuda"))
    reference_phase(args.seed)
    mechanism_reference_phase(args.seed)
    ddnm_reference_phase(args.seed)
    launches, walls = slice_phase(model, model_args, args.batch, args.steps, args.runs,
                                  args.seed, "bf16")
    say(f"bf16 sampling wall time per run (s): {[round(w, 3) for w in walls]} on {smi}")
    gn_entry["launches"] = launches["groupnorm_silu"]
    for op_name, op_launches in mechanism_phases(model, model_args, args).items():
        gn_entry[f"launches_{op_name}"] = op_launches["groupnorm_silu"]
    # DDNM+ doubles the Heun step count, as generate_conditional.py does
    for op_name, n in ddnm_phase(model, model_args, args.batch, 2 * args.steps,
                                 args.seed).items():
        gn_entry[f"launches_ddnm_{op_name}"] = n
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    qmodel, _ = loading.load_model(
        str(CKPT_256), str(SETUP_256), dtype=torch.bfloat16, init_random_if_missing=True,
        rng_seed=args.seed, remat=True, quant="int8", fused_gn_quant=True)
    torch.cuda.synchronize()
    say(f"256 px fused-int8 UNet built in {time.perf_counter() - t0:.2f} s")
    k2_entry, k3_entry = int8_kernel_phase(*int8_shapes_of_forward(qmodel, args.batch, res,
                                                                   "cuda"))
    int8_reference_phase(args.seed)
    qlaunches, qwalls = slice_phase(qmodel, model_args, args.batch, args.steps, 1,
                                    args.seed, "fused int8")
    say(f"fused int8 sampling wall time per run (s): {[round(w, 3) for w in qwalls]} "
        f"on {smi}")
    k2_entry["launches"] = qlaunches["gn_silu_quant"]
    k3_entry["launches"] = qlaunches["int8_conv"]
    say(f"groupnorm_silu launches: {launches['groupnorm_silu']} on the bf16 slice, "
        f"{qlaunches['groupnorm_silu']} on the int8 slice")
    for name, n in (("groupnorm_silu", launches["groupnorm_silu"]),
                    ("groupnorm_silu", gn_entry["launches_super_resolution"]),
                    ("groupnorm_silu", gn_entry["launches_inpainting"]),
                    *(("groupnorm_silu", gn_entry[f"launches_ddnm_{o}"]) for o in DDNM_OPS),
                    ("groupnorm_silu", qlaunches["groupnorm_silu"]),
                    ("gn_silu_quant", k2_entry["launches"]),
                    ("int8_conv", k3_entry["launches"])):
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its main path")
    say(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [gn_entry, k2_entry, k3_entry]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
