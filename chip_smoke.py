#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``free_hunch_tpu_torch``) on one card.

    python3 chip_smoke.py                      # batch 8, 10 Heun steps
    python3 chip_smoke.py --steps 30           # the paper's 30 Heun steps
    python3 chip_smoke.py --batch 2 --steps 3  # a shorter rehearsal
    python3 chip_smoke.py --k3                 # K3 alone: host and device
                                               # time, every small-layer cut
    python3 chip_smoke.py --gn                 # K1 and K2 alone: per pass and
                                               # per call, every forward shape
    python3 chip_smoke.py --mechanisms         # phases 3b, 4b-4d alone
    python3 chip_smoke.py --ddnm               # phases 3c and 4e alone, draw routes
    python3 chip_smoke.py --driver             # phases 5a-5c alone
    python3 chip_smoke.py --multiprocess       # phases 5d and 5e alone
    python3 chip_smoke.py --vae                # phase 6 alone
    python3 chip_smoke.py --model-axis         # phase 7 alone

Phases, in order; any failure raises and exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, the TF32
   flags the port sets, and the build of every kernel from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. kernels: every hand-written kernel against its plain PyTorch version on
   the card, at every distinct shape a main path gives it, with times, the
   bound and the library call of the same function (timed only, never
   used): K1 (GroupNorm+SiLU) at one bf16 forward's shapes (and, checked
   but not timed, at those of the driver's last batch of 2), K2 (GroupNorm+
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
   it, and checked against the module calls counted by hooks; one more run,
   cut to ``PROFILE_STEPS`` (3) Heun steps, under ``torch.profiler`` gives
   the device time by kernel family and the device's idle share, and one
   traced guided call the GroupNorm backward's share.
4b. the same protocol on the bf16 torso for super-resolution x4 and for
   inpainting with a random mask, one run each (wall time, peak memory, CG
   niter, K1 launches against the hooks).
4c. a sweep of the seven other mechanisms on gaussian blur, SR x4 and
   inpainting at full width (batch 2, ``SWEEP_STEPS`` (2) Heun steps): wall
   ms and K1 launches per guided call.
4d. one pixel-space and one Fourier-coordinate deblur CG iteration at
   256 px, batch 8, on the same system: the reading behind
   ``cg_coords='auto'``.
4e. DDNM+ through the raw 256 px bf16 UNet on the DDPM grid, batch 8,
   twice the Heun step count (20 steps), sigma_y 0.1, eta 1.0, on the
   gaussian blur, SR x4 and inpainting with a random mask: wall time, peak
   memory, ||A x - y|| / ||y||, the final sample, and K1's launches, equal
   to the hooks' GroupNorm32 count; each operator's count joins K1's
   entry of the ``kernels`` line as ``launches_ddnm_<operator>``. The
   gaussian blur's run once more under the profiler.
5a. driver reference: the port's ``Evaluator`` at 32 px (f32 tiny UNet,
   Free Hunch with the flat prior on the gaussian blur, centre crops of
   three bundled PNGs, batch 2, 3 Heun steps) on the card against the same
   run on the CPU, which draws the same random numbers: each journal
   record's and the totals' PSNR, SSIM and LPIPS, the final samples and
   the CG counts within 3b's limits, and native LPIPS (seeded VGG npz) and
   the proxy Inception's features within 1e-4.
5b. the driver at full width: ``generate_conditional.cmdline`` on the ten
   bundled 256 px images (seeded random weights, bf16 torso with remat),
   Free Hunch with the DCT-diagonal prior on the 61x61 gaussian blur,
   ``--steps`` Heun steps, batch 8, FID against proxy statistics of the same images:
   the artifacts checked, wall per batch, images per minute, the share of
   wall outside ``sample_loop``, peak memory, K1 launches against the
   hooks (``launches_driver`` in K1's entry).
5c. the same entry with ``--conditioning_mechanism=ddnm`` on inpainting
   with a fresh mask per image, the steps doubled
   (``launches_driver_ddnm``).
5d. the driver as a world of two ranks on the one card, started as a user
   starts it (``python -m torch.distributed.run --nproc_per_node=2 -m
   free_hunch_tpu_torch.generate_conditional``; gloo, since NCCL cannot put
   two ranks on one device), 5b's protocol with a batch of 5 a rank at
   ``MP_STEPS`` (5) Heun steps in the whole script (``--multiprocess``
   alone: ``--steps``): the
   artifacts, 10 images, totals equal to the sample-weighted mean of both
   journals, FID of both ranks' moments, each rank's K1 launches equal to
   its hooks (``launches_driver_world2``, both ranks), peak memory and wall
   per rank.
5e. kill and resume: DDNM+ on inpainting at batch 2 (three batches a rank,
   twice 5d's steps) as a world of two, uninterrupted, then with rank 1 armed to SIGKILL
   itself after one batch, then resumed: replayed records unchanged, every
   record and the totals within 5a's limits of the uninterrupted run.
6. the SD-VAE at full width (sd-vae-ft-mse, 83,653,863 seeded random
   parameters, f32): ``StabilityVAEEncoder`` on the ten bundled images at
   batch 8, each direction's wall, peak memory, K1's launches against the
   hooks (``launches_vae``: 52 norms a batch), K1 against its plain version
   at every distinct norm call (``max_abs_err_vae``) timed against
   ``group_norm`` + ``silu`` and the bytes bound (``ms_vae``,
   ``plain_ms_vae``, ``library_ms_vae``, ``bound_ms_vae``), the
   channels-last interior against NCHW with copies, and the narrow VAE of
   the CPU tests on the card against the CPU.
7. the model axis (``mesh_shape=data:1,model:2``), two ranks of one model
   group on the one card over gloo. 7a: ``python -m torch.distributed.run
   --nproc_per_node=2 chip_smoke.py --model-axis-rank=<dir>``; each rank
   builds the 256 px bf16 UNet with remat, height-sharded over the group (the
   same seeded weights, checked by a hash), holds K1's sharded path (stats
   entry, gather, apply entry that merges) to ``groupnorm_silu_sharded_plain``
   at every distinct shard shape of one forward and times it against the
   unsharded K1 at the whole shape (and checks it at every shard shape of
   7b's batch), then runs Free Hunch with the d-sharded state (the slice's
   operator and prior, capacity 34, batch 8,
   3 Heun steps: 5 guided calls), recording each call's wall, the
   collectives and the bytes each rank sends, K1's stats and apply
   launches against the hooks, the covariance state's bytes and the peak
   memory; rank 0 then replays each guided call unsharded from the sharded
   run's inputs and gathered state (``MA_CALL_REL_RMS`` per call, equal CG
   counts) and runs the same steps unsharded (the final sample within
   ``MA_FINAL_REL_RMS``; wall per call; peak memory). 7b: the driver as a
   user starts it with ``--mesh_shape=data:1,model:2`` on two bundled
   images, 5 Heun steps: two images counted, one journal, the ranks'
   totals, x0 and samples equal, the first guided call's x0 within
   ``MA_CALL_REL_RMS`` of the same command's as a world of one (every
   call and the final samples read), PSNR and SSIM within ``MA_PSNR_ABS``
   and ``MA_SSIM_ABS`` of its, each rank's K1 stats and apply launches
   equal to its hooks; ``--model-axis`` alone also runs 7b without halos,
   a control that must break the first call's limit. K1's sharded entry
   joins the ``kernels`` line as ``groupnorm_silu_sharded``, with
   ``max_abs_err_batch_2`` from every shard shape of 7b's batch.
7c. the fused int8 torso on a height shard: two ranks of ``data:1,model:2``
   (``torch.distributed.run ... --model-axis-part=7c``) build the 256 px
   UNet with ``quant="int8"``, ``fused_gn_quant`` and remat; K2's shard
   entries (stats, the gather, merge, apply; the flagged route forced
   once with ``full``) against ``gn_silu_quant_sharded_plain`` at every
   distinct shard shape of one forward (``K2S_SCALE_REL``,
   ``K2S_CODE_FRAC``), timed against the unsharded K2 at the whole shape,
   with the control (each rank's own abs-max) that must read outside the
   scale limit; K3 at every distinct shape of one sharded forward and vjp
   (the halo'd 3x3 sites with padding (0, 1)) bitwise its plain version,
   timed against ``_int_mm`` on an im2col; then 7a's slice on this torso,
   each guided call (``MA_INT8_STEPS`` Heun steps, 3 guided calls) against
   rank 0's unsharded int8 replay from the same
   inputs and state (``MA_INT8_CALL_REL_RMS``, equal CG counts), K1's, K2's
   and K3's launches against the hooks, peak memory a rank.
7d. ragged shards: three ranks of ``data:1,model:3``, the 256 px bf16 UNet
   (256 rows as 96, 96, 64, down to 8 as 3, 3, 2): K1's count-weighted
   shard entries against their twin at every ragged shard shape, timed;
   one forward and one vjp at batch 2 against rank 0's unsharded model:
   the denoiser at the schedule's first sigma (as 7b's first guided call)
   and the raw UNet within ``MA_DENOISED_REL_RMS``, the raw UNet's vjp
   within the larger of that and twice the bf16 torso's own distance from
   f32 (measured in the run), K1's launches against the hooks.
7e. DDNM+ through the driver: ``--conditioning_mechanism=ddnm
   --mesh_shape=data:1,model:2`` on two bundled images (inpainting,
   ``--num_steps=MA_DDNM_STEPS``, 10 DDNM+ steps) against the same command
   as a world of one:
   the final samples (``MA_DDNM_REL_RMS``), PSNR and SSIM (``MA_PSNR_ABS``,
   ``MA_SSIM_ABS``), one journal, K1's launches against the hooks. K2's
   shard entries join the ``kernels`` line as ``gn_silu_quant_sharded``,
   K3 on the shards as ``int8_conv_halo``, and 7d's readings join
   ``groupnorm_silu_sharded`` (``*_ragged``).

The last two lines of standard output are the ``kernels`` JSON object and
the ``device`` JSON object. Without a CUDA card the script prints no result
and exits with code 2.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import signal
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
from free_hunch_tpu_torch import config as fht_config
from free_hunch_tpu_torch import eval as teval
from free_hunch_tpu_torch import eval_ddnm as teval_ddnm
from free_hunch_tpu_torch.data import png
from free_hunch_tpu_torch.data.dataset import shard_indices
from free_hunch_tpu_torch.generate_conditional import cmdline
from free_hunch_tpu_torch.guidance import choose_conditioning_mechanism, solvers
from free_hunch_tpu_torch.metrics import fid as fid_mod
from free_hunch_tpu_torch.metrics import lpips as lpips_mod
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


PHASE_WALLS: dict = {}


@contextlib.contextmanager
def timed_phase(name: str):
    """Record the host wall of one phase of the whole script, in seconds."""
    t0 = time.perf_counter()
    yield
    PHASE_WALLS[name] = round(time.perf_counter() - t0, 1)
    say(f"phase {name}: {PHASE_WALLS[name]} s of wall time")


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


def check_gn(shape, dtype, silu, gen, reps=20, backward=True, measure=True, groups=32,
             eps=1e-5):
    """Kernel vs plain on one shape (``groups`` groups, ``eps``); returns the
    error and, with ``measure``, the measurements: eager ms (calls back to
    back), the card's ms alone (a CUDA graph's replay), each pass's device
    ms, the plain version's and the library call's ms and, with
    ``backward``, the plain-autograd backward's."""
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    y = gn.groupnorm_silu_cuda(x, g, b, groups, eps, silu)
    want = gn.groupnorm_silu_plain(x, g, b, groups, eps, silu)
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
    if not measure:
        return dict(shape=shape, dtype=str(dtype).replace("torch.", ""), silu=silu,
                    max_abs_err=err, tol=tol)
    xp = x.permute(0, 3, 1, 2)
    gl, bl = g.to(dtype), b.to(dtype)
    if silu:
        lib = lambda: F.silu(F.group_norm(xp, groups, gl, bl, eps))  # noqa: E731
    else:
        lib = lambda: F.group_norm(xp, groups, gl, bl, eps)  # noqa: E731
    k1 = lambda: gn.groupnorm_silu_cuda(x, g, b, groups, eps, silu)  # noqa: E731
    ms, graph_ms, passes = time_ms(k1, reps), time_ms(k1, reps, graph=True), pass_ms(k1)
    plain_ms = time_ms(lambda: gn.groupnorm_silu_plain(x, g, b, groups, eps, silu),
                       max(2, reps // 4))
    library_ms = time_ms(lib, reps)
    # the guidance vjp's pullback through this call: the autograd.Function's
    # backward, which recomputes the plain version (there is no backward kernel)
    bwd_ms = 0.0
    if backward:
        xg = x.detach().requires_grad_(True)
        yg = gn.groupnorm_silu(xg, g, b, groups, eps, silu)
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


def gn_kernel_phase(forward_shapes: Counter, small_batches: dict) -> dict:
    """K1 against its plain version at the named shapes and every shape of
    one main-path forward (timed), and at every shape of each smaller batch
    the driver's runs give it (``small_batches``: batch -> shapes; see
    ``driver_batch_sizes``), whose plans have more and shorter chunks per
    sample (checked, not timed; ``max_abs_err_batch_<n>``)."""
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
    for n, shapes in sorted(small_batches.items(), reverse=True):
        say(f"  the driver's batch of {n}, per distinct shape (calls):")
        err = 0.0
        for (shape, dtype, silu), calls in sorted(shapes.items(),
                                                  key=lambda kv: -np.prod(kv[0][0])):
            r = check_gn(shape, dtype, silu, gen, measure=False)
            err = max(err, r["max_abs_err"])
            say(f"    {calls:3d} x {r['shape']} {r['dtype']} silu={silu}: err "
                f"{r['max_abs_err']:.3g} ({r['tol']})")
        e[f"max_abs_err_batch_{n}"] = err
    say(f"  sum over the {sum(forward_shapes.values())} calls of one forward: kernel "
        f"{e['ms']:.3f} ms (graph {e['graph_ms']:.3f} ms; passes "
        f"{fmt_passes(e['passes_ms'])}; {e['tbps']:.2f} TB/s on the function's bytes), "
        f"plain {e['plain_ms']:.3f} ms, library {e['library_ms']:.3f} ms, "
        f"bound {e['bound_ms']:.3f} ms ({e['bound_by']}: {e['bytes_ms']:.3f} ms of bytes at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s, {e['ops_ms']:.3f} ms of f32 operations); "
        f"their backward in the guidance vjp (plain autograd) {e['bwd_ms']:.3f} ms")
    return {k: e[k] for k in list(GN_ENTRY) + ["max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "graph_ms",
                                               "passes_ms", "tbps"]
            + [k for k in e if k.startswith("max_abs_err_batch_")]}


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


def im2col(xq, kh: int, kw: int, pad):
    """(n*Ho*Wo, kh*kw*I) int8 patches in K3's K order, for the yardstick;
    ``pad`` one int or (height, width)."""
    ph, pw = q._pads(pad)
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
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


PROFILE_STEPS = 3  # the profiled run's depth (5 guided calls)
SWEEP_STEPS = 2    # 4c: 3 guided calls a mechanism and operator


def slice_phase(model, model_args, batch: int, steps: int, runs: int, seed: int,
                label: str, op_name: str = "gaussian_blur", profile: bool = True):
    """The bench.py protocol on ``model`` and the operator ``op_name``
    (with ``profile``, one more run of at most ``PROFILE_STEPS`` Heun steps
    under the profiler, then one guided call traced); returns the first
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
    # the profiler's processing grows with the run's kernels: it reads a run
    # cut to PROFILE_STEPS Heun steps
    psteps = min(steps, PROFILE_STEPS)
    pxs, ps0 = schedule(precond, psteps)
    t0 = time.perf_counter()
    busy = profile and device_breakdown(lambda: edm.sample_loop(denoise, mech, noise, y, pxs,
                                                                gen, sigma0_scaled=ps0))
    fused = counted["calls"].get("fused", 0)
    if busy:
        t1 = time.perf_counter()
        fh = mech.mech
        backward_share(lambda: fh(denoise, noise * s0, y, float(xs["sigma_hat"][0]),
                                  fh.init_state(batch, (3, res, res))),
                       2 * psteps - 1, busy,
                       RANGES[1] if fused else RANGES[0])
        say(f"  profiler wall: the {psteps}-step run and its breakdown {t1 - t0:.1f} s, "
            f"the traced guided call {time.perf_counter() - t1:.1f} s")

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
    sweep_phase(model, model_args, 2, SWEEP_STEPS, args.seed)
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


def ddnm_draws_phase(model, model_args, steps: int, seed: int) -> None:
    """``--ddnm`` only: what the sampler's per-step draw costs DDNM+ on
    inpainting at the driver's two batches, 8 and 2. The draw comes from a
    generator on the card, from a CPU generator through pinned memory
    (``free_hunch_tpu_torch.randn``, the driver's route, which gives the
    card the CPU's draws) or from a CPU generator through pageable memory,
    whose copy waits for the card's queue at every step. Three rounds, the
    order reversed every other round; host clock ending in a synchronise."""
    dev = next(model.parameters()).device
    res = model_args["image_size"]
    drawn = ddnm.randn

    def pageable(shape, generator=None, dtype=torch.float32, device=None):
        return torch.randn(tuple(shape), generator=generator, dtype=dtype).to(device)

    routes = {"card generator": (drawn, "cuda"), "CPU pinned": (drawn, "cpu"),
              "CPU pageable": (pageable, "cpu")}
    say(f"DDNM+ per-step draw routes: inpainting, {steps} steps, sigma_y 0.1, eta 1.0; "
        f"wall s per run, three rounds:")
    for batch in (8, 2):
        a_funcs = ddnm_operator("inpainting", res, dev, seed, rows=batch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        truth = torch.rand((batch, 3 * res * res), generator=gen, device=dev) * 2 - 1
        with torch.no_grad():
            y = a_funcs.A(truth)
        y = y + 0.1 * torch.randn(y.shape, generator=gen, device=dev)
        noise = torch.randn((batch, 3, res, res), generator=gen, device=dev)
        walls = {name: [] for name in routes}
        for rnd in range(3):
            for name in (list(routes) if rnd % 2 == 0 else list(routes)[::-1]):
                draw, where = routes[name]
                ddnm.randn = draw
                try:
                    g = torch.Generator(device=where).manual_seed(seed)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ddnm.ddnm_sample(lambda x, t: model(x, t)[:, :3], a_funcs, noise, y,
                                     num_steps=steps, sigma_y=0.1, eta=1.0, generator=g)
                    torch.cuda.synchronize()
                    walls[name].append(time.perf_counter() - t0)
                finally:
                    ddnm.randn = drawn
        say(f"  batch {batch}: " + "; ".join(
            f"{name} {[round(w, 3) for w in ws]} (median {float(np.median(ws)):.3f})"
            for name, ws in walls.items()))
        del a_funcs, y, noise
        torch.cuda.empty_cache()


# -- phase 5: the evaluation driver ------------------------------------------

DRIVER_RES, DRIVER_IMAGES, DRIVER_BATCH, DRIVER_STEPS = 32, 3, 2, 3
# phases 5b and 5c: the ten bundled images at batch 8, so a batch of 8, then 2
FULL_IMAGES, FULL_BATCH = 10, 8
# 5a's limits, card against CPU: each journal record's and total's PSNR,
# SSIM and LPIPS within 3b's per-call relative limit (1e-3 of the CPU's
# value, at least of 1), the final float samples within 3b's last-call
# limit, and the metric networks' outputs (native LPIPS distances and the
# VGG features each distance reads, pool3 features) within 1e-4 of the
# CPU's largest |value|: TF32 convolutions (~1e-3 relative per value) break
# the features' limits, though a distance averages such noise away
DRIVER_METRIC_REL, DRIVER_SAMPLE_ABS, DRIVER_NET_REL = MECH_REF_CALL_REL, MECH_REF_LAST_ABS, 1e-4
LPIPS_VGG = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
             (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512),
             (21, 512, 512), (24, 512, 512), (26, 512, 512), (28, 512, 512))


def lpips_npz(path: Path, seed: int) -> str:
    """A seeded VGG16 features + LPIPS heads npz in the format of
    ``metrics/lpips.py::convert_torch_weights`` (no real weights are in the
    repository)."""
    rng = np.random.default_rng(seed)
    vgg = {}
    for idx, cin, cout in LPIPS_VGG:
        vgg[f"{idx}.weight"] = rng.normal(0, np.sqrt(2.0 / (cin * 9)),
                                          (cout, cin, 3, 3)).astype(np.float32)
        vgg[f"{idx}.bias"] = rng.normal(0, 0.01, cout).astype(np.float32)
    lins = {f"lin{i}": rng.uniform(0, 1, c).astype(np.float32)
            for i, c in enumerate(lpips_mod.TAP_CHANNELS)}
    np.savez(path, **lpips_mod.convert_torch_weights(vgg, lins))
    return str(path)


class DriverReference:
    """Phase 5a's witness: the port's ``Evaluator`` at 32 px (the f32 tiny
    UNet with seeded weights) on centre crops of three bundled PNGs, Free
    Hunch with the flat prior on the gaussian blur, batch 2 (a ragged last
    batch), 3 Heun steps. The driver draws every random number on the CPU,
    so the card and the CPU get the same noise and measurement draws. Also
    the metric networks alone: native LPIPS from a seeded VGG npz at 64 px,
    and pool3 features of the proxy Inception (``random_params(0)``) on two
    images."""

    def __init__(self, seed: int, tmp: Path):
        self.tmp = tmp
        self.data = tmp / "images32"
        self.data.mkdir(parents=True, exist_ok=True)
        o = (256 - DRIVER_RES) // 2
        for p in sorted((ROOT / "data" / "imagenet" / "00000").glob("*.png"))[:DRIVER_IMAGES]:
            png.write_png(str(self.data / p.name),
                          np.ascontiguousarray(png.read_png(str(p))[o:o + DRIVER_RES,
                                                                    o:o + DRIVER_RES]))
        self.setup = tmp / "setup32.txt"
        self.setup.write_text(
            f"--image_size {DRIVER_RES} --num_channels 32 --num_res_blocks 1 "
            f"--channel_mult 1,2 --attention_resolutions 8 --num_head_channels 16 "
            f"--learn_sigma True --class_cond False --resblock_updown True "
            f"--use_scale_shift_norm True")
        self.state = loading.random_init_(create_model(
            **{**TINY, "dtype": torch.float32}), seed=seed).state_dict()
        self.lpips_path = lpips_npz(tmp / "lpips_vgg.npz", seed)
        rng = np.random.default_rng(seed + 5)
        a = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
        self.lpips_pair = (a, np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32))
        self.fid_images = rng.uniform(-1, 1, (2, 3, DRIVER_RES, DRIVER_RES)).astype(np.float32)

    def run(self, dev: str, name: str, nudge: float = 0.0) -> dict:
        """One side: the Evaluator's journal records, totals, final float
        samples per batch and CG counts per guided call, K1's launches, and
        the metric networks' outputs. ``nudge`` multiplies every denoiser
        output by (1 + nudge N(0, 1)), a stand-in for another device's
        rounding."""
        outdir = self.tmp / name
        opts = fht_config.load_config(args=dict(
            outdir=str(outdir), openai_setup_path=str(self.setup),
            openai_state_dict_path=str(self.tmp / "absent.pt"), allow_random_init=True,
            dataset_path=str(self.data), total_images=DRIVER_IMAGES,
            batch_size=DRIVER_BATCH, num_steps=DRIVER_STEPS, seeds=[0],
            conditioning_mechanism="online_covariance",
            image_base_covariance="dct_diagonal_noinfo", operator_name="gaussian_blur",
            intensity=3.0, noise_sigma=0.1, dtype="float32", mesh_shape="data:1",
            num_other_images_to_save=10))
        ev = teval.Evaluator(opts, device=dev)
        ev.model.load_state_dict(self.state)
        samples, recs = [], []
        build, batch_fn, precond = ev._mech_builder, ev._batch_fn, ev.precond
        rng = np.random.default_rng(1)

        def recorded(op):
            recs.append(CallRecorder(build(op)))
            return recs[-1]

        def denoise(x, sigma, y=None):
            x0, var = precond(x, sigma, y=y)
            n = torch.as_tensor(rng.normal(size=tuple(x0.shape)), dtype=x0.dtype,
                                device=x0.device)
            return x0 * (1 + nudge * n), var

        def batch(*a, **k):
            out = batch_fn(*a, **k)
            samples.append(out[0].cpu().numpy())
            return out

        ev._mech_builder, ev._batch_fn = recorded, batch
        if nudge:
            ev.precond = denoise
        before = gn.launches
        sync(dev)
        t0 = time.perf_counter()
        totals = ev.run()
        sync(dev)
        wall = time.perf_counter() - t0
        launches = gn.launches - before
        with open(outdir / "metrics_rank00.jsonl") as f:
            records = [json.loads(line) for line in f]
        lp = lpips_mod.make_lpips(self.lpips_path, device=dev)
        extract, _ = fid_mod.make_extractor(None, device=dev)
        a, b = (torch.as_tensor(v, device=dev) for v in self.lpips_pair)
        with torch.no_grad():
            dist = lp(a, b)
            taps = lp._vgg_taps((a - lp.shift) / lp.scale)
        feats = extract(torch.as_tensor(self.fid_images, device=dev))
        return dict(records=records, totals=totals, samples=samples,
                    niter=[[c["niter"] for c in r.calls] for r in recs], launches=launches,
                    wall_s=wall, lpips=dist.cpu().numpy(), features=feats.cpu().numpy(),
                    **{f"lpips_tap{i}": t.cpu().numpy() for i, t in enumerate(taps)},
                    files=sorted(str(p.relative_to(outdir)) for p in outdir.rglob("*")
                                 if p.is_file()))


def driver_reference_failures(cpu: dict, card: dict) -> tuple:
    """(readings as error / limit, what breaks the limits) of phase 5a,
    card against CPU."""
    ratio, bad = {}, []

    def hold(key, err, lim):
        ratio[key] = float(err / lim)
        if not err <= lim:
            bad.append(f"{key}: {float(err):.3g} > {float(lim):.3g}")

    if [r["batch"] for r in card["records"]] != [r["batch"] for r in cpu["records"]] or \
            [r["n"] for r in card["records"]] != [r["n"] for r in cpu["records"]]:
        bad.append("journal batches differ")
    rows = list(zip(cpu["records"], card["records"])) + [(cpu["totals"], card["totals"])]
    for i, (c, g) in enumerate(rows):
        where = "totals" if i == len(rows) - 1 else f"batch {i}"
        for k in ("psnr", "ssim", "lpips"):
            hold(f"{where} {k}", abs(g[k] - c[k]), DRIVER_METRIC_REL * max(abs(c[k]), 1.0))
    if len(card["samples"]) != len(cpu["samples"]):
        bad.append("batch counts differ")
    for i, (c, g) in enumerate(zip(cpu["samples"], card["samples"])):
        if g.shape != c.shape or not np.isfinite(g).all():
            bad.append(f"batch {i} samples {g.shape} not finite or not {c.shape}")
        else:
            hold(f"batch {i} samples", np.abs(g - c).max(), DRIVER_SAMPLE_ABS)
    if card["niter"] != cpu["niter"]:
        bad.append(f"CG niter card {card['niter']} cpu {cpu['niter']}")
    for k in ["lpips", "features"] + [k for k in cpu if k.startswith("lpips_tap")]:
        hold(k, np.abs(card[k] - cpu[k]).max(), DRIVER_NET_REL * np.abs(cpu[k]).max())
    if card["files"] != cpu["files"]:
        bad.append("artifact layouts differ")
    return ratio, bad


def driver_reference_phase(seed: int, card: str = "cuda"):
    """Phase 5a: the witness on the card against the CPU; anything outside
    the limits, or no K1 launch on the card, raises."""
    with tempfile.TemporaryDirectory() as tmp:
        ref = DriverReference(seed, Path(tmp))
        cpu = ref.run("cpu", "cpu")
        gpu = ref.run(card, "card")
    ratio, bad = driver_reference_failures(cpu, gpu)
    if cpu["launches"] != 0 or gpu["launches"] == 0:
        bad.append(f"K1 launches cpu {cpu['launches']} card {gpu['launches']}")
    say(f"driver reference 32 px (Evaluator, Free Hunch, gaussian blur, {DRIVER_IMAGES} "
        f"images, batch {DRIVER_BATCH}, {DRIVER_STEPS} Heun steps), card vs CPU: "
        f"error / limit {json.dumps({k: round(v, 5) for k, v in ratio.items()})}; CG niter "
        f"{gpu['niter']}; card K1 launches {gpu['launches']}; wall card "
        f"{gpu['wall_s']:.2f} s, CPU {cpu['wall_s']:.2f} s; totals card "
        f"{ {k: gpu['totals'][k] for k in ('psnr', 'ssim', 'lpips')} }"
        + (f"; FAILS: {bad}" if bad else ""))
    if bad:
        raise AssertionError(f"driver reference: card and CPU disagree: {bad}")


def hooked_driver(run):
    """Run ``run()`` (a ``generate_conditional.cmdline`` call) with the
    GroupNorm32 calls of the model the driver loads counted by hooks and
    the time inside ``sample_loop`` / ``ddnm_sample`` read on the host
    clock, the card synchronised. Returns (result, K1 launches, hooks'
    count, [(sampler seconds, batch)], wall s, peak GiB)."""
    calls = Counter()
    samplings = []
    load, loop, ddnm_loop = teval.load_model, teval.sample_loop, teval_ddnm.ddnm_sample

    def count(mod, args):
        calls["gn"] += 1

    def hooked_load(*a, **k):
        model, args = load(*a, **k)
        for m in model.modules():
            if isinstance(m, GroupNorm32):
                m.register_forward_pre_hook(count)
        return model, args

    def timed(fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            samplings.append((time.perf_counter() - t0, int(a[2].shape[0])))
            return out
        return wrapper

    teval.load_model, teval.sample_loop = hooked_load, timed(loop)
    teval_ddnm.ddnm_sample = timed(ddnm_loop)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gn.launches
    finally:
        teval.load_model, teval.sample_loop = load, loop
        teval_ddnm.ddnm_sample = ddnm_loop
    return (result, launches, calls["gn"], samplings, wall,
            torch.cuda.max_memory_allocated() / 2**30)


def check_artifacts(outdir: Path, label: str, n: int, batches: int, fid: bool):
    """The driver's outputs in ``outdir``: every image, finite totals of
    ``n`` images, ``batches`` journal records over every rank's journal."""
    results = json.loads((outdir / "results.json").read_text())
    for sub in ("images", "cond_images", "forward_images"):
        got = sorted(p.name for p in (outdir / sub).glob("*.png"))
        if got != [f"{i:06d}_000000.png" for i in range(n)]:
            raise AssertionError(f"{label}: {sub}/ holds {got}")
    shape = png.read_png(str(outdir / "images" / "000000_000000.png")).shape
    keys = ("psnr", "ssim", "lpips") + (("fid",) if fid else ())
    journal = [line for p in sorted(outdir.glob("metrics_rank*.jsonl"))
               for line in p.read_text().splitlines()]
    text = (outdir / "results.txt").read_text()
    bad = [k for k in keys if not np.isfinite(results.get(k, np.nan))]
    if bad or results["images"] != n or len(journal) != batches or \
            results["lpips_is_proxy"] is not True or (fid and results["fid_is_proxy"] is not True) \
            or not all(f"{k.upper()}: " in text for k in keys) \
            or not (outdir / "config.json").exists() or \
            "PSNR:" not in (outdir / "output.log").read_text():
        raise AssertionError(f"{label}: artifacts wrong: results {results}, journal "
                             f"{len(journal)} records, non-finite {bad}")
    return results, shape


def driver_args(seed: int) -> list:
    """The command-line options every full-width driver run shares: the
    ten bundled 256 px images (``data/imagenet``, whose ``dct_variance.pt``
    is the Free Hunch prior), seeded random weights, bf16 torso with remat."""
    data = ROOT / "data" / "imagenet"
    return [f"--openai_setup_path={SETUP_256}", f"--openai_state_dict_path={CKPT_256}",
            "--allow_random_init=true", f"--dataset_path={data}", f"--total_images={FULL_IMAGES}",
            f"--batch_size={FULL_BATCH}", "--seeds=0", "--dtype=bfloat16", "--remat=true",
            "--noise_sigma=0.1", "--num_other_images_to_save=10", "--mesh_shape=data:1",
            f"--seed={seed}"]


def bundled_images() -> np.ndarray:
    """The ten bundled images, uint8 (10, 3, 256, 256)."""
    from free_hunch_tpu_torch.data.dataset import ImageFolderDataset
    ds = ImageFolderDataset(str(ROOT / "data" / "imagenet"))
    return np.stack([ds[i][0] for i in range(len(ds))])


def proxy_ref_stats(path: Path, dev: str) -> None:
    """Proxy-Inception FID statistics of the bundled images, saved to ``path``."""
    t0 = time.perf_counter()
    extract, is_proxy = fid_mod.make_extractor(None, device=dev)
    stats = fid_mod.FeatureStats()
    images = bundled_images()
    stats.add(extract(torch.as_tensor(images, device=dev).float() / 127.5 - 1))
    stats.save(str(path), is_proxy=is_proxy)
    say(f"driver: proxy FID statistics of the {len(images)} bundled images in "
        f"{time.perf_counter() - t0:.2f} s")


def driver_phase(seed: int, steps: int, smi: str, dev: str = "cuda") -> dict:
    """Phases 5b and 5c: the port's ``generate_conditional`` entry at full
    width on the ten bundled images, seeded random weights: Free Hunch on
    the 61x61 gaussian blur with FID against proxy statistics of the same
    images, then DDNM+ on inpainting with a fresh mask per image. Returns
    K1's launches of each run."""
    out = {}
    common = driver_args(seed)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        proxy_ref_stats(tmp / "ref_stats.npz", dev)
        fh_dir = tmp / "free_hunch"
        argv = common + [f"--outdir={fh_dir}", "--conditioning_mechanism=online_covariance",
                         "--image_base_covariance=dct_diagonal", "--operator_name=gaussian_blur",
                         "--kernel_size=61", "--intensity=3.0", f"--num_steps={steps}",
                         "--cov_capacity=auto", f"--fid_ref_stats={tmp / 'ref_stats.npz'}"]
        res, launches, hooks, samp, wall, peak = hooked_driver(lambda: cmdline(argv, dev))
        results, shape = check_artifacts(fh_dir, "driver Free Hunch", 10, 2, fid=True)
        sampling = sum(s for s, _ in samp)
        run_wall = results["time_taken"]
        say(f"driver 5b, generate_conditional Free Hunch (online_covariance, dct_diagonal "
            f"prior, gaussian blur 61x61, sigma_s 0.1, {steps} Heun steps) on the 10 "
            f"bundled {shape[0]} px images, batch 8 (batches of 8 and 2), bf16 torso with "
            f"remat, on {smi}:")
        say(f"  results: PSNR {results['psnr']:.4f}, SSIM {results['ssim']:.4f}, LPIPS "
            f"{results['lpips']:.4f} (proxy), FID {results['fid']:.4f} (proxy), images "
            f"{results['images']}")
        say(f"  wall: whole entry {wall:.3f} s; evaluation loop {run_wall:.3f} s; per batch "
            f"(sampler s, images) {[(round(s, 3), b) for s, b in samp]}; "
            f"{10 / run_wall * 60:.3f} images per minute of the loop, "
            f"{10 / wall * 60:.3f} of the whole entry; share outside sample_loop "
            f"{1 - sampling / run_wall:.4f} of the loop, {1 - sampling / wall:.4f} of the "
            f"entry (model load, IO, decode, metrics, FID)")
        say(f"  peak device memory {peak:.3f} GiB; K1 launches {launches} (hooks: {hooks} "
            f"GroupNorm32 calls)")
        if not 0 < launches == hooks:
            raise AssertionError(f"driver Free Hunch: {launches} K1 launches, hooks {hooks}")
        out["driver"] = launches

        dd_dir = tmp / "ddnm"
        argv = common + [f"--outdir={dd_dir}", "--conditioning_mechanism=ddnm",
                         "--operator_name=inpainting", f"--num_steps={steps}"]
        res, launches, hooks, samp, wall, peak = hooked_driver(lambda: cmdline(argv, dev))
        results, _ = check_artifacts(dd_dir, "driver DDNM+", 10, 2, fid=False)
        config = json.loads((dd_dir / "config.json").read_text())
        say(f"driver 5c, generate_conditional DDNM+ on inpainting (fresh mask per image, "
            f"sigma_y 0.1), --num_steps={steps} doubled to {config['num_steps']}, batch 8, "
            f"on {smi}: wall {wall:.3f} s whole entry, {results['time_taken']:.3f} s loop, "
            f"sampler per batch {[(round(s, 3), b) for s, b in samp]}; PSNR "
            f"{results['psnr']:.4f}, SSIM {results['ssim']:.4f}, LPIPS {results['lpips']:.4f}"
            f" (proxy); peak device memory {peak:.3f} GiB; K1 launches {launches} (hooks: "
            f"{hooks})")
        if config["num_steps"] != 2 * steps or not 0 < launches == hooks:
            raise AssertionError(f"driver DDNM+: {config['num_steps']} steps, {launches} K1 "
                                 f"launches, hooks {hooks}")
        out["driver_ddnm"] = launches
    return out


# -- phases 5d and 5e: the driver as a world of two ranks on the one card ------

# Each rank's instrumentation, loaded at interpreter start through
# PYTHONPATH (``sitecustomize``), so the ranks run the user's command
# unchanged: a global forward pre-hook counts the GroupNorm32 calls, the
# Evaluator's totals are kept, and at exit the rank writes K1's launches
# (unsharded and, under a model axis, the sharded stats and apply
# entries'), the hooks' count, the totals, its peak device memory and its
# wall time. It first runs the ``sitecustomize`` that the
# rest of the path holds, if any, so the ranks keep their environment.
RANK_PROBE = """
import atexit, importlib.machinery, importlib.util, json, os, sys, time
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
if os.environ.get("LOCAL_RANK") is not None and os.environ.get("FH_SMOKE_PROBE"):
    _t0 = time.perf_counter()
    import torch
    from free_hunch_tpu_torch.models.unet import GroupNorm32
    from free_hunch_tpu_torch.ops import groupnorm as _gn
    _calls = [0]

    def _count(mod, args):
        if isinstance(mod, GroupNorm32):
            _calls[0] += 1

    torch.nn.modules.module.register_module_forward_pre_hook(_count)
    from free_hunch_tpu_torch import eval as _ev
    _run, _totals = _ev.Evaluator.run, {}
    _samples = None
    if os.environ.get("FH_SMOKE_SAMPLES"):
        import chip_smoke as _cs
        _samples = {"d": [], "x0": [], "x": [], "niter": []}
        _keeping = _cs.keeping_samples(_samples)  # held: its exit restores the loop
        _keeping.__enter__()
        if os.environ.get("FH_SMOKE_NO_HALO"):
            from free_hunch_tpu_torch.parallel import collectives as _coll
            _coll.halo_rows = _cs.no_halo

    def _keep(self):
        res = _run(self)
        _totals.update({k: v for k, v in res.items()
                        if isinstance(v, (int, float)) and k != "time_taken"})
        return res

    _ev.Evaluator.run = _keep

    def _report():
        rank = int(os.environ["RANK"])
        peak = torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_initialized() else 0.0
        with open(os.path.join(os.environ["FH_SMOKE_PROBE"], f"rank{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, launches=_gn.launches, hooks=_calls[0], peak_gib=peak,
                           wall_s=time.perf_counter() - _t0, sharded=_gn.sharded_launches,
                           totals=_totals), f)
        if _samples is not None:
            _keeping.__exit__(None, None, None)
            torch.save(_samples, os.path.join(os.environ["FH_SMOKE_PROBE"], f"rank{rank}_x.pt"))

    atexit.register(_report)
"""
WORLD = 2
MP_STEPS = 5  # 5d's and 5e's depth in the whole script
MP_TIMEOUT_S = 600
DDNM_MP_BATCH = 2


def driver_batch_sizes() -> set:
    """The batch sizes K1 sees in the driver's runs: the ``FULL_IMAGES``
    strided over one rank (5b, 5c) and over ``WORLD`` ranks (5d, at
    ``FULL_BATCH``; 5e, at ``DDNM_MP_BATCH``), each rank's share cut into
    batches."""
    sizes = set()
    for world, batch in ((1, FULL_BATCH), (WORLD, FULL_BATCH), (WORLD, DDNM_MP_BATCH)):
        for rank in range(world):
            n = len(shard_indices(FULL_IMAGES, world, rank))
            sizes.update(min(batch, n - i) for i in range(0, n, batch))
    return sizes


def python_path(*dirs) -> str:
    """``dirs`` ahead of the caller's ``PYTHONPATH``."""
    return os.pathsep.join([str(d) for d in dirs] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p])


def rank_env(rank: int, port: int, **extra) -> dict:
    """The environment torchrun gives rank ``rank`` of ``WORLD`` on one
    host, whose store (at ``port``) the launcher holds, as torchrun's agent
    does: no port is chosen and then freed for a rank to bind."""
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               TORCHELASTIC_USE_AGENT_STORE="True", TORCHELASTIC_RESTART_COUNT="0",
               PYTHONPATH=python_path(ROOT), OMP_NUM_THREADS="4")
    env.update(extra)
    return env


def journal_records(outdir: Path) -> dict:
    """rank -> the lines of its journal."""
    return {int(p.stem[-2:]): p.read_text().splitlines()
            for p in sorted(outdir.glob("metrics_rank*.jsonl"))}


def weighted_totals(journals: dict) -> dict:
    recs = [json.loads(line) for lines in journals.values() for line in lines]
    n = sum(r["n"] for r in recs)
    return {k: sum(r[k] * r["n"] for r in recs) / n for k in ("psnr", "ssim", "lpips")}


def world2_phase(seed: int, steps: int, smi: str) -> int:
    """Phase 5d: ``python -m torch.distributed.run --nproc_per_node=2 -m
    free_hunch_tpu_torch.generate_conditional`` as a user starts it, both
    ranks on the one card (gloo, which the port picks: NCCL cannot put two
    ranks on one device), 5b's protocol with each rank's batch of 5. Returns
    K1's launches over both ranks; each rank's equal its hooks."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        proxy_ref_stats(tmp / "ref_stats.npz", "cuda")
        (tmp / "probe").mkdir()
        (tmp / "site").mkdir()
        (tmp / "site" / "sitecustomize.py").write_text(RANK_PROBE)
        out = tmp / "world2"
        argv = driver_args(seed) + [
            f"--outdir={out}", "--conditioning_mechanism=online_covariance",
            "--image_base_covariance=dct_diagonal", "--operator_name=gaussian_blur",
            "--kernel_size=61", "--intensity=3.0", f"--num_steps={steps}",
            "--cov_capacity=auto", f"--fid_ref_stats={tmp / 'ref_stats.npz'}"]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={WORLD}", "-m", "free_hunch_tpu_torch.generate_conditional",
               *argv]
        env = dict(os.environ, PYTHONPATH=python_path(tmp / "site", ROOT),
                   FH_SMOKE_PROBE=str(tmp / "probe"), OMP_NUM_THREADS="4")
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=MP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"world of 2: exit {run.returncode}\n{run.stdout[-4000:]}\n"
                                 f"{run.stderr[-4000:]}")
        results, shape = check_artifacts(out, "world of 2", FULL_IMAGES, WORLD, fid=True)
        probes = [json.loads((tmp / "probe" / f"rank{r}.json").read_text())
                  for r in range(WORLD)]
        journals = journal_records(out)
        want = weighted_totals(journals)
        bad = [k for k in want if abs(results[k] - want[k]) > 1e-12 * max(abs(want[k]), 1)]
        say(f"driver 5d, torch.distributed.run --nproc_per_node={WORLD} generate_conditional "
            f"(gloo, both ranks on the one card), 5b's protocol ({steps} Heun steps, batch "
            f"{FULL_BATCH}: one batch of 5 per rank) on {smi}:")
        say(f"  results: PSNR {results['psnr']:.4f}, SSIM {results['ssim']:.4f}, LPIPS "
            f"{results['lpips']:.4f} (proxy), FID {results['fid']:.4f} (proxy, moments of "
            f"both ranks), images {results['images']}; journals "
            f"{ {r: len(v) for r, v in journals.items()} } records")
        say(f"  wall: whole command {wall:.3f} s; per rank (interpreter start to exit) "
            f"{[round(p['wall_s'], 3) for p in probes]} s; evaluation loop, rank 0 "
            f"{results['time_taken']:.3f} s; {FULL_IMAGES / wall * 60:.3f} images per minute "
            f"of the command")
        say(f"  per rank: peak device memory {[round(p['peak_gib'], 3) for p in probes]} GiB; "
            f"K1 launches {[p['launches'] for p in probes]} (hooks: "
            f"{[p['hooks'] for p in probes]} GroupNorm32 calls)")
        if bad or results["images"] != FULL_IMAGES or not np.isfinite(results["fid"]) or \
                any(not 0 < p["launches"] == p["hooks"] for p in probes) or \
                sorted(journals) != list(range(WORLD)):
            raise AssertionError(f"world of 2: totals off the journals' weighted mean {bad}, "
                                 f"results {results}, probes {probes}")
        return sum(p["launches"] for p in probes)


def ddnm_world(out: Path, seed: int, steps: int, envs=({}, {}), extra=()) -> tuple:
    """Both ranks of a DDNM+ inpainting run started as torchrun starts them
    (its environment), each with its own environment additions; returns the
    processes, their log files and the rendezvous store they meet at."""
    argv = driver_args(seed) + [f"--outdir={out}", "--conditioning_mechanism=ddnm",
                                "--operator_name=inpainting", f"--num_steps={steps}",
                                f"--batch_size={DDNM_MP_BATCH}", *extra]
    store = torch.distributed.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    procs, logs = [], []
    for r in range(WORLD):
        log = open(out.parent / f"{out.name}_rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "free_hunch_tpu_torch.generate_conditional", *argv],
            cwd=ROOT, env=rank_env(r, store.port, **envs[r]), stdout=log,
            stderr=subprocess.STDOUT))
    return procs, logs, store


def wait_world(procs, logs, store, label: str, timeout: float = MP_TIMEOUT_S) -> list:
    """Wait for the ranks (killing any past ``timeout``); ``store``, their
    rendezvous, is held until then."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    for log in logs:
        log.close()
    if codes != [0] * WORLD:
        tails = [Path(log.name).read_text()[-3000:] for log in logs]
        raise AssertionError(f"{label}: exit codes {codes}\n" + "\n".join(tails))
    return codes


def kill_resume_phase(seed: int, steps: int, smi: str) -> None:
    """Phase 5e: DDNM+ on inpainting (fresh mask per image, ``steps``
    doubled, batch 2: three batches a rank, no FID) as a world of two on
    the card, three ways: uninterrupted; with rank 1 armed by both gates
    (``--fault_kill_after_batches=1`` and ``FREE_HUNCH_FAULT_INJECT=1``), so
    it SIGKILLs itself after its first batch, and rank 0 killed once it has
    journaled its batches or after a bounded wait; then both resumed. The
    resumed journals keep the replayed records byte for byte; every record
    and the totals agree with the uninterrupted run's within 5a's limits
    (whether byte-equal too is reported)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        whole, fault = tmp / "whole", tmp / "fault"
        t0 = time.perf_counter()
        wait_world(*ddnm_world(whole, seed, steps), "5e uninterrupted")
        wall_whole = time.perf_counter() - t0
        want = journal_records(whole)
        per_rank = len(want[0])

        t0 = time.perf_counter()
        procs, logs, store = ddnm_world(fault, seed, steps,
                                        envs=({}, {"FREE_HUNCH_FAULT_INJECT": "1"}),
                                        extra=("--fault_kill_after_batches=1",))
        code1 = procs[1].wait(timeout=MP_TIMEOUT_S)
        deadline = time.perf_counter() + 120
        while procs[0].poll() is None and time.perf_counter() < deadline:
            if len(journal_records(fault).get(0, [])) == per_rank:
                time.sleep(5)  # its final gather waits for the dead peer
                break
            time.sleep(1)
        if procs[0].poll() is None:
            procs[0].kill()
        code0 = procs[0].wait()
        del store
        for log in logs:
            log.close()
        wall_fault = time.perf_counter() - t0
        kept = journal_records(fault)
        if code1 != -signal.SIGKILL or len(kept.get(1, [])) != 1 or \
                (fault / "results.json").exists():
            raise AssertionError(f"5e fault run: rank 1 exit {code1} (want SIGKILL), journals "
                                 f"{ {r: len(v) for r, v in kept.items()} }\n"
                                 f"{Path(logs[1].name).read_text()[-3000:]}")

        t0 = time.perf_counter()
        wait_world(*ddnm_world(fault, seed, steps, extra=("--resume=true",)), "5e resumed")
        wall_resume = time.perf_counter() - t0
        got = journal_records(fault)
        results = json.loads((fault / "results.json").read_text())
        results_whole = json.loads((whole / "results.json").read_text())
        bad, ratio, equal = [], {}, {}
        n_kept = sum(len(v) for v in kept.values())
        for r in range(WORLD):
            if got[r][:len(kept[r])] != kept[r]:
                bad.append(f"rank {r}: a replayed record changed")
            if len(got[r]) != len(want[r]):
                bad.append(f"rank {r}: {len(got[r])} records, want {len(want[r])}")
            for i, (g, w) in enumerate(zip(got[r], want[r])):
                gj, wj = json.loads(g), json.loads(w)
                if gj["batch"] != wj["batch"] or gj["n"] != wj["n"]:
                    bad.append(f"rank {r} record {i}: batch {gj['batch']} vs {wj['batch']}")
                for k in ("psnr", "ssim", "lpips"):
                    lim = DRIVER_METRIC_REL * max(abs(wj[k]), 1.0)
                    ratio[f"rank {r} record {i} {k}"] = abs(gj[k] - wj[k]) / lim
                equal[f"rank {r} record {i} ({'replayed' if i < len(kept[r]) else 'recomputed'})"] \
                    = g == w
        for k in ("psnr", "ssim", "lpips"):
            ratio[f"totals {k}"] = abs(results[k] - results_whole[k]) / (
                DRIVER_METRIC_REL * max(abs(results_whole[k]), 1.0))
        bad += [k for k, v in ratio.items() if not v <= 1]
        if results["resumed_batches"] != n_kept or results["images"] != FULL_IMAGES:
            bad.append(f"resumed_batches {results['resumed_batches']} (want {n_kept}), images "
                       f"{results['images']}")
        say(f"driver 5e, kill and resume: DDNM+ inpainting ({2 * steps} steps, batch "
            f"{DDNM_MP_BATCH}, {per_rank} batches a rank), world of 2 on the one card, on {smi}:")
        say(f"  wall: uninterrupted {wall_whole:.3f} s; fault run {wall_fault:.3f} s (rank 1 "
            f"exit {code1}, rank 0 exit {code0}; journaled {n_kept} batches: "
            f"{ {r: len(v) for r, v in kept.items()} }); resumed {wall_resume:.3f} s "
            f"(resumed_batches {results['resumed_batches']})")
        say(f"  records byte-equal to the uninterrupted run's: {equal}; error / limit max "
            f"{max(ratio.values()):.5f}; totals PSNR {results['psnr']:.4f} (uninterrupted "
            f"{results_whole['psnr']:.4f})" + (f"; FAILS: {bad}" if bad else ""))
        if bad:
            raise AssertionError(f"5e kill and resume: {bad}")


# -- phase 6: the SD-VAE at full width ------------------------------------------

VAE_BATCH = 8
VAE_SMALL_RES = 32


def vae_norm_shapes(vae) -> tuple:
    """Hooks on every VAEGroupNorm: (Counter of (NHWC shape, silu) -> calls,
    the hooks' list, the running count)."""
    from free_hunch_tpu_torch.models.vae import VAEGroupNorm
    seen = Counter()

    def hook(mod, args):
        seen[(tuple(args[0].permute(0, 2, 3, 1).shape), mod.apply_silu)] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in vae.modules()
             if isinstance(m, VAEGroupNorm)]
    return seen, hooks


def vae_layout_reading(vae, images, lat) -> None:
    """The VAE interior's layout: channels-last (no copy at a norm) against
    NCHW with a copy in and out of every norm, one encode + decode of a
    batch, timed in turns."""
    from free_hunch_tpu_torch.models import vae as vae_mod

    dev = next(vae.parameters()).device
    x8 = torch.as_tensor(images[:VAE_BATCH], device=dev).float() / 255
    z8 = lat[:VAE_BATCH].contiguous()

    def both():
        with torch.no_grad():
            vae.encode(x8)
            vae.decode(z8)

    plain_forward = vae_mod.VAEGroupNorm.forward

    def copying_forward(self, x):
        return plain_forward(self, x.contiguous()).contiguous()

    layout = {"channels_last": [], "nchw_copies": []}
    for turn in ("channels_last", "nchw_copies", "nchw_copies", "channels_last"):
        if turn == "nchw_copies":
            vae.to(memory_format=torch.contiguous_format)
            vae_mod.VAEGroupNorm.forward = copying_forward
            vae._in = lambda t: t.float().contiguous()
        try:
            layout[turn].append(time_ms(both, 3))
        finally:
            vae_mod.VAEGroupNorm.forward = plain_forward
            vae.__dict__.pop("_in", None)
            vae.to(memory_format=torch.channels_last)
    say(f"  layout, one encode + decode of a batch of {VAE_BATCH} (ms, in turns): "
        f"channels-last {[round(v, 3) for v in layout['channels_last']]}, NCHW with a copy "
        f"in and out of each norm {[round(v, 3) for v in layout['nchw_copies']]}")


def vae_phase(seed: int, smi: str, dev: str = "cuda", layout: bool = False) -> dict:
    """Phase 6: ``StabilityVAEEncoder`` with ``VAEConfig()`` (sd-vae-ft-mse,
    83,653,863 seeded random parameters, f32, TF32 off) on the ten bundled
    256 px images, batch 8: ``encode_pixels``, ``encode_latents`` (a CPU
    generator's draws), ``decode``; the wall of each direction, the peak
    memory, K1's launches against the hooks (52 norms a batch, 2 batches);
    K1 against its plain version at every distinct norm call (f32, eps
    1e-6, 32 groups) with times against ``group_norm`` + ``silu`` and the
    bytes bound; with ``layout`` (``--vae`` alone), the interior's layout
    (channels-last, no copy at a norm) against NCHW with a copy in and out
    of every norm, timed in turns; and the narrow VAE of the CPU tests on
    the card against the CPU."""
    from free_hunch_tpu_torch.data.encoders import StabilityVAEEncoder
    from free_hunch_tpu_torch.models import vae as vae_mod

    cfg = vae_mod.VAEConfig()
    torch.manual_seed(seed)
    state = vae_mod.AutoencoderKL(cfg).state_dict()
    enc = StabilityVAEEncoder(batch_size=VAE_BATCH)
    t0 = time.perf_counter()
    enc.init(device=dev, params=state)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in enc.vae.parameters())
    say(f"VAE (sd-vae-ft-mse layout, {n_params:,} seeded random parameters, f32) built in "
        f"{time.perf_counter() - t0:.2f} s")
    images = bundled_images()
    seen, hooks = vae_norm_shapes(enc.vae)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    raw = enc.encode_pixels(images)
    torch.cuda.synchronize()
    t_pix = time.perf_counter() - t0
    t0 = time.perf_counter()
    lat = enc.encode_latents(raw, generator=torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    t_lat = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = enc.decode(lat)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches, calls = gn.launches, sum(seen.values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    for h in hooks:
        h.remove()
    warm = []
    for fn, arg in ((enc.encode_pixels, images), (enc.decode, lat)):
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    n = len(images)
    batches = -(-n // VAE_BATCH)
    n_norms = sum(isinstance(m, vae_mod.VAEGroupNorm) for m in enc.vae.modules())
    f = cfg.downscale
    ok = (tuple(raw.shape) == (n, 8, 256 // f, 256 // f) and tuple(lat.shape) == (n, 4, 32, 32)
          and tuple(dec.shape) == (n, 3, 256, 256) and dec.dtype == torch.uint8
          and bool(torch.isfinite(raw).all()) and bool(torch.isfinite(lat).all()))
    say(f"VAE 6, StabilityVAEEncoder on the {n} bundled 256 px images, batch {VAE_BATCH} "
        f"({batches} batches), on {smi}: encode_pixels {t_pix:.3f} s, encode_latents "
        f"{t_lat:.4f} s, decode {t_dec:.3f} s (first calls; again: encode_pixels "
        f"{warm[0]:.3f} s, decode {warm[1]:.3f} s); peak device memory {peak:.3f} GiB; latents "
        f"{tuple(lat.shape)} std {float(lat.std()):.4f}; decoded {tuple(dec.shape)} "
        f"{dec.dtype}; K1 launches {launches} (hooks: {calls} calls of the {n_norms} "
        f"VAEGroupNorms, {len(seen)} distinct)")
    if not ok or not 0 < launches == calls == n_norms * batches:
        raise AssertionError(f"VAE: shapes or launches wrong: raw {tuple(raw.shape)} lat "
                             f"{tuple(lat.shape)} dec {tuple(dec.shape)}, launches {launches}, "
                             f"hooks {calls}, want {n_norms * batches}")

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    say("  K1 vs plain at every distinct VAE norm call (f32, eps 1e-6; calls x ms):")
    for (shape, silu), k in sorted(seen.items(), key=lambda kv: -np.prod(kv[0][0])):
        r = check_gn(shape, torch.float32, silu, gen, backward=False, groups=cfg.norm_num_groups,
                     eps=cfg.norm_eps)
        rows.append((k, r))
        say(f"    {k:3d} x {r['shape']} silu={silu}: err {r['max_abs_err']:.3g} kernel "
            f"{r['ms']:.4f} (graph {r['graph_ms']:.4f}) plain {r['plain_ms']:.4f} library "
            f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']})")
    e = sum_entry(GN_ENTRY, rows, ("ms", "graph_ms", "plain_ms", "library_ms"))
    say(f"  sum over the {calls} norm calls of the run: kernel {e['ms']:.3f} ms (graph "
        f"{e['graph_ms']:.3f}), plain {e['plain_ms']:.3f} ms, library {e['library_ms']:.3f} "
        f"ms, bound {e['bound_ms']:.3f} ms ({e['bound_by']}); max error {e['max_abs_err']:.3g}")

    if layout:
        vae_layout_reading(enc.vae, images, lat)

    # the narrow VAE of the CPU tests, card against CPU, within their limits
    small = vae_mod.VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                              latent_channels=4, norm_num_groups=8)
    torch.manual_seed(seed + 1)
    cpu = vae_mod.AutoencoderKL(small).eval()
    card = vae_mod.AutoencoderKL(small)
    card.load_state_dict(cpu.state_dict())
    card.to_device(dev).eval()
    rng = np.random.default_rng(seed)
    xs = torch.as_tensor(rng.uniform(0, 1, (3, 3, VAE_SMALL_RES, VAE_SMALL_RES)),
                         dtype=torch.float32)
    zs = torch.as_tensor(rng.normal(size=(3, 4, VAE_SMALL_RES // 2, VAE_SMALL_RES // 2)),
                         dtype=torch.float32)
    before = gn.launches
    with torch.no_grad():
        outs_cpu = (*cpu.encode(xs), cpu.decode(zs))
        outs_card = (*card.encode(xs.to(dev)), card.decode(zs.to(dev)))
    small_ratio = [float((g.cpu() - c).abs().max() / (1e-5 * c.abs().max()))
                   for g, c in zip(outs_card, outs_cpu)]
    say(f"  narrow VAE (32, 64 channels, 8 groups) at {VAE_SMALL_RES} px, card vs CPU: "
        f"mean, std, decode error / (1e-5 of the largest |value|) "
        f"{[round(v, 5) for v in small_ratio]}; K1 launches {gn.launches - before}")
    if not max(small_ratio) <= 1 or gn.launches - before != 24:
        raise AssertionError(f"narrow VAE: card vs CPU {small_ratio}, launches "
                             f"{gn.launches - before}")
    return dict(launches_vae=launches, max_abs_err_vae=e["max_abs_err"], ms_vae=e["ms"],
                plain_ms_vae=e["plain_ms"], library_ms_vae=e["library_ms"],
                bound_ms_vae=e["bound_ms"])


# -- phase 7: the model axis: one model group of two ranks on the one card ------

MA_MESH = "data:1,model:2"
MA_WORLD = 2
MA_STEPS = 3          # 7a: 3 Heun steps, 5 guided calls
MA_CAP = 34
MA_DRIVER_IMAGES, MA_DRIVER_STEPS = 2, 5
MA_TIMEOUT_S = 600
# 7a's limits, sharded against unsharded, as relative RMS (||a - b|| / ||b||).
# Per guided call (teacher-forced: the unsharded mechanism from the
# sharded run's x_t and its state gathered whole) 1e-2: the bf16 torso
# rounds once more or less where cuDNN takes other algorithms on the
# half-height shapes and where the shards' statistics merge in another
# order; measured 1.72e-6 to 1.74e-3 teacher-forced, 1.47e-3 to 1.74e-3
# free-running at the first four calls (NVIDIA H100 80GB HBM3, 700 W); a
# shard without its halos reads 4.7e-2 (32 px, CPU). The final sample of
# the two free-running runs 5e-2: the last Heun corrector divides the
# fourth call's guidance update by sigma = 0.002 and scales it by h / 2 =
# 1.729 (864x), so that call's bf16 noise reaches the sample; measured
# 2.09e-2 on the card, and 1.87e-2 at 32 px on the CPU
# (tests/test_torch_chip_smoke_model_axis.py); without halos 0.238.
MA_CALL_REL_RMS, MA_FINAL_REL_RMS = 1e-2, 5e-2
# 7b, the model axis against a world of one. The first guided call's
# denoiser output (the UNet's, before the guidance) starts from equal
# inputs; it differs by the bf16 torso's rounding on half-height shapes and
# the merge order, 1.64e-3 relative RMS on the card, and 1.89e-2 without
# halos (NVIDIA H100 80GB HBM3, 700 W; 8.4e-4 and 4.3e-2 at 32 px on the
# CPU): held to 5e-3, about 3x from each. The guidance and the last Heun
# corrector amplify the difference: x0 read 3.9e-2 at the first call (3.0e-2
# without halos) and the final samples 0.320 (0.319 without halos), so
# they, and the CG counts, are read, not held. PSNR and SSIM, computed from
# the final samples, are held only to agree within that noise: read 9.1e-4
# and 0.026 dB, 3.2e-5 and 2.2e-3 in two runs whose K1 rounded its merge
# differently (without halos 0.0047 dB, 1.4e-3). Random weights put PSNR
# near 4.2 dB.
MA_DENOISED_REL_RMS = 5e-3
MA_PSNR_ABS, MA_SSIM_ABS = 0.1, 1e-2
GNS_ENTRY = dict(name="groupnorm_silu_sharded", route="cuda",
                 source="free_hunch_tpu_torch/csrc/groupnorm.cu",
                 replaces="free_hunch_tpu/ops/pallas_groupnorm.py:117")


def rel_rms_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm((got - want).ravel()) / max(np.linalg.norm(want.ravel()),
                                                             1e-30))


class ShardedCallRecorder:
    """Pass-through guidance mechanism that records each call's x0, CG
    count, wall ms (the card synchronised on both sides), and the model
    group's collectives and the bytes this rank contributed to them. With
    ``keep_inputs`` it also keeps each call's x_t, sigma and state on the
    host, the d-sharded covariance gathered whole (outside the counts and
    the wall), for a teacher-forced unsharded replay."""

    def __init__(self, mech, dev="cuda", keep_inputs=False):
        from free_hunch_tpu_torch.parallel import collectives as coll
        self.mech, self.calls, self.coll, self.state, self.dev = mech, [], coll, None, dev
        self.keep_inputs = keep_inputs

    def init_state(self, batch, img_shape):
        self.d = int(np.prod(img_shape))
        return self.mech.init_state(batch, img_shape)

    def _whole(self, state):
        from free_hunch_tpu_torch.parallel import sharded_cov
        cov, mg = state.cov, self.mech.model_group
        with torch.no_grad():
            d = self.d
            cov = cov._replace(diag=sharded_cov.gather_d(cov.diag, mg, d),
                               Ut=sharded_cov.gather_d(cov.Ut, mg, d))
        return state_to(state._replace(cov=cov), "cpu")

    def __call__(self, denoise, x_t, y, sigma, state):
        rec = dict(x_t=x_t.cpu(), sigma=sigma, state=self._whole(state)) \
            if self.keep_inputs else {}
        sync(self.dev)
        c0, b0 = self.coll.counts["calls"], self.coll.counts["bytes"]
        t0 = time.perf_counter()
        x0, self.state = self.mech(denoise, x_t, y, sigma, state)
        sync(self.dev)
        rec.update(ms=(time.perf_counter() - t0) * 1e3, x0=x0.cpu().numpy(),
                   niter=self.state.cg_niter, collectives=self.coll.counts["calls"] - c0,
                   bytes=self.coll.counts["bytes"] - b0)
        self.calls.append(rec)
        return x0, self.state


def gn_shard_shapes(model, batch: int, res: int) -> Counter:
    """(shard NHWC shape, dtype, apply_silu) -> calls over one no-grad
    sharded forward (every rank of the group runs it)."""
    seen = Counter()

    def hook(mod, inputs):
        x = inputs[0]
        seen[(tuple(x.permute(0, 2, 3, 1).shape), x.dtype, mod.apply_silu)] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        model(torch.zeros((batch, 3, res, res), device="cuda"),
              torch.full((batch,), 500.0, device="cuda"))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return seen


def check_gn_sharded(shape, dtype, silu, mg, reps=10, rows=None) -> dict:
    """K1's sharded path (stats entry, the gather, the apply entry that
    merges) against ``groupnorm_silu_sharded_plain`` on this rank's rows of
    one whole tensor, drawn alike on every rank; the ranks time it
    together, or with ``reps=0`` only check it. ``rows``: each rank's rows
    (default: this rank's on every rank). Limit as ``check_gn``'s."""
    from free_hunch_tpu_torch.parallel import collectives as coll
    n, h, w, c = shape
    rows = (h,) * mg.model_size if rows is None else tuple(rows)
    gen = torch.Generator(device="cuda").manual_seed(n * sum(rows) * w * c + c)
    full = (torch.randn((n, sum(rows), w, c), generator=gen, device="cuda") * 2
            + 0.5).to(dtype)
    start = sum(rows[:mg.model_index])
    x = full[:, start:start + h].contiguous()
    g = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    y = gn.groupnorm_silu_sharded_cuda(x, g, b, 32, 1e-5, silu, mg)
    want = gn.groupnorm_silu_sharded_plain(x, g, b, 32, 1e-5, silu, mg)
    torch.cuda.synchronize()
    err = float((y.float() - want.float()).abs().max())
    if dtype == torch.float32:
        limit = 1e-5 * max(1.0, float(want.abs().max()))
    else:
        limit = 2 * 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    if not err <= limit:
        raise AssertionError(f"sharded groupnorm {shape} {dtype}: max abs err {err} > {limit}")
    row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""), silu=silu,
               max_abs_err=err, limit=limit, rows=rows)
    if not reps:
        return row
    parts = coll.gather_replicated(gn.shard_stats_cuda(x)[None], 0, mg).contiguous()
    row.update(
        full=full, g=g, b=b,
        ms=time_ms(lambda: gn.groupnorm_silu_sharded_cuda(x, g, b, 32, 1e-5, silu, mg), reps),
        stats_ms=time_ms(lambda: gn.shard_stats_cuda(x), reps),
        apply_ms=time_ms(lambda: gn.shard_apply_cuda(x, parts, g, b, 32, 1e-5, silu), reps),
        plain_ms=time_ms(lambda: gn.groupnorm_silu_sharded_plain(x, g, b, 32, 1e-5, silu, mg),
                         max(2, reps // 4)),
        bytes_ms=(2 * x.numel() * x.element_size() + 2 * c * 4) / HBM_BYTES_PER_S * 1e3,
        ops_ms=GN_FLOPS_PER_ELEM[silu] * x.numel() / F32_FLOP_PER_S * 1e3)
    return row


def model_axis_rank(outdir: Path, seed: int, dev: str = "cuda", setup: Path = None,
                    batch: int = FULL_BATCH, steps: int = MA_STEPS) -> None:
    """Phase 7a, one rank of ``torch.distributed.run --nproc_per_node=2``:
    the 256 px bf16 UNet with remat and the height shard, Free Hunch with
    the d-sharded state (gaussian blur 61x61 std 3, sigma_s 0.1, the DCT
    prior, capacity 34, vjp guidance, EDM Heun), batch 8, ``MA_STEPS``
    steps; before it, on the card, K1's sharded path at every distinct
    shard shape; after it, on rank 0 alone, the same steps unsharded with
    the same weights and inputs, and the unsharded K1 at the same whole
    shapes. Writes ``rank<r>.pt``. ``dev``, ``setup`` (default
    ``SETUP_256``), ``batch`` and ``steps`` let the CPU rehearse it."""
    from free_hunch_tpu_torch.parallel import collectives as coll
    from free_hunch_tpu_torch.parallel import dist, mesh
    dist.init()
    mg = mesh.make_model_groups(MA_MESH)
    rank = dist.get_rank()
    card = torch.device(dev).type == "cuda"
    setup = SETUP_256 if setup is None else setup
    model, model_args = loading.load_model(
        str(CKPT_256), str(setup), dtype=torch.bfloat16, init_random_if_missing=True,
        rng_seed=seed, remat=True, device=dev, model_group=mg)
    digest = hashlib.sha256()
    for t in model.state_dict().values():
        digest.update(t.detach().float().cpu().numpy().tobytes())
    hashes = dist.all_gather_object(digest.hexdigest()[:16])
    res = model_args["image_size"]
    out = dict(rank=rank, weights=hashes, group=(mg.data_index, mg.model_index), gn_rows=[],
               gn_rows_driver=[])

    if card:  # K1's sharded path at every distinct shard shape of one forward
        rows = [(calls, check_gn_sharded(shape, dtype, silu, mg))
                for (shape, dtype, silu), calls in sorted(
                    gn_shard_shapes(model, batch, res).items(),
                    key=lambda kv: -np.prod(kv[0][0]))]
        dist.barrier()
        if rank == 0:  # the unsharded K1 at the same whole shapes, this rank alone
            for _, r in rows:
                r["unsharded_ms"] = time_ms(lambda: gn.groupnorm_silu_cuda(
                    r["full"], r["g"], r["b"], 32, 1e-5, r["silu"]), 10)
        dist.barrier()
        out["gn_rows"] = [(calls, {k: v for k, v in r.items() if k not in ("full", "g", "b")})
                          for calls, r in rows]
        del rows
        # checked, not timed: every distinct shard shape of 7b's batch, whose
        # plan cuts each sample into other chunks
        out["gn_rows_driver"] = [
            check_gn_sharded(shape, dtype, silu, mg, reps=0)
            for shape, dtype, silu in gn_shard_shapes(model, MA_DRIVER_IMAGES, res)]

    # the main path
    precond = loading.wrap_precond(model, model_args)
    op = slice_operator("gaussian_blur", res, dev, seed)
    xs, s0 = schedule(precond, steps)
    gen = torch.Generator().manual_seed(seed)
    cond = (torch.rand((batch, 3, res, res), generator=gen) * 2 - 1).to(dev)
    y = op.forward(cond, generator=torch.Generator().manual_seed(seed + 1))
    noise = torch.randn((batch, 3, res, res), generator=gen).to(dev)
    calls = Counter()
    hooks = [m.register_forward_pre_hook(lambda mod, a: calls.update(["gn"]))
             for m in model.modules() if isinstance(m, GroupNorm32)]
    mech = ShardedCallRecorder(free_hunch(op, res, MA_CAP, "dct_diagonal",
                                          model_group=mg),
                               dev, keep_inputs=True)
    sync(dev)
    if card:
        torch.cuda.reset_peak_memory_stats()
    gn.sharded_launches.update(stats=0, apply=0)
    zero_counts()
    coll.reset_counts()
    t0 = time.perf_counter()
    x, _, diag = edm.sample_loop(precond, mech, noise, y, xs, sigma0_scaled=s0,
                                 collect_diagnostics=True)
    sync(dev)
    wall = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    cov = mech.state.cov
    inputs = [{k: c.pop(k) for k in ("x_t", "sigma", "state")} for c in mech.calls]
    out.update(wall=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30 if card else 0.0,
               launches=dict(gn.sharded_launches), launches_unsharded=gn.launches,
               hooks=calls["gn"], calls=mech.calls, x=x.cpu().numpy(),
               niter=diag["cg_niter"].numpy(),
               cov_bytes={k: getattr(cov, k).numel() * getattr(cov, k).element_size()
                          for k in ("diag", "Ut", "M")},
               cov_shape=tuple(cov.Ut.shape), collectives=dict(coll.counts))
    state = model.state_dict()
    del model, precond, mech
    dist.barrier()
    if rank == 0:  # the same steps unsharded, this rank alone on the card
        with torch.device(dev):
            ref = create_model(dtype=torch.bfloat16, remat=True, **model_args)
        ref.load_state_dict(state)
        del state
        ref.eval().requires_grad_(False)
        pre_ref = loading.wrap_precond(ref, model_args)
        # teacher-forced: each guided call from the sharded run's inputs
        forced = free_hunch(op, res, MA_CAP, "dct_diagonal")
        out["forced"] = []
        for c in inputs:
            x0, st = forced(pre_ref, c["x_t"].to(dev), y, c["sigma"], state_to(c["state"], dev))
            out["forced"].append(dict(x0=x0.cpu().numpy(), niter=st.cg_niter))
        del inputs
        # free-running
        rmech = ShardedCallRecorder(free_hunch(op, res, MA_CAP, "dct_diagonal"), dev)
        sync(dev)
        if card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xr, _, rdiag = edm.sample_loop(pre_ref, rmech, noise, y, xs, sigma0_scaled=s0,
                                       collect_diagnostics=True)
        sync(dev)
        out.update(ref_wall=time.perf_counter() - t0, ref_calls=rmech.calls,
                   ref_x=xr.cpu().numpy(), ref_niter=rdiag["cg_niter"].numpy(),
                   ref_peak_gib=torch.cuda.max_memory_allocated() / 2**30 if card else 0.0,
                   ref_cov_bytes={k: getattr(rmech.state.cov, k).numel() * 4
                                  for k in ("diag", "Ut", "M")})
    torch.save(out, outdir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy()


def model_axis_failures(ranks: list) -> tuple:
    """(readings, what breaks 7a's limits) from the ranks' outputs: each
    guided call's x0 against the unsharded mechanism's from the same inputs
    and state (relative RMS within ``MA_CALL_REL_RMS``) with equal CG
    counts, the free-running final samples (within ``MA_FINAL_REL_RMS``),
    equal weights and x0 on both ranks, a finite sample, and on each rank
    K1's stats and apply launches equal to the GroupNorm32 hooks, with no
    unsharded launch. The free-running calls are read, not held."""
    r0 = ranks[0]
    errs = [rel_rms_err(c["x0"], rc["x0"]) for c, rc in zip(r0["calls"], r0["forced"])]
    free = [rel_rms_err(c["x0"], rc["x0"]) for c, rc in zip(r0["calls"], r0["ref_calls"])]
    final = rel_rms_err(r0["x"], r0["ref_x"])
    niter = [c["niter"] for c in r0["calls"]]
    ref_niter = [c["niter"] for c in r0["forced"]]
    same = all(np.array_equal(c["x0"], c1["x0"])
               for r in ranks[1:] for c, c1 in zip(r0["calls"], r["calls"]))
    bad = [f"call {i}: x0 relative RMS {e:.3g}" for i, e in enumerate(errs)
           if not e <= MA_CALL_REL_RMS]
    if not final <= MA_FINAL_REL_RMS:
        bad.append(f"final sample relative RMS {final:.3g}")
    if niter != ref_niter or len(errs) != len(r0["calls"]) or \
            len(free) != len(r0["calls"]):
        bad.append(f"CG niter {niter} vs {ref_niter}")
    if len(set(r0["weights"])) != 1:
        bad.append(f"the ranks' weights differ: {r0['weights']}")
    if not same or not np.isfinite(r0["x"]).all():
        bad.append("the ranks' x0 differ, or the sample is not finite")
    for r in ranks:
        if not (0 < r["launches"]["stats"] == r["launches"]["apply"] == r["hooks"]) or \
                r["launches_unsharded"] != 0:
            bad.append(f"rank {r['rank']}: K1 sharded launches {r['launches']}, hooks "
                       f"{r['hooks']}, unsharded {r['launches_unsharded']}")
    return dict(errs=errs, free=free, final=final, niter=niter, ref_niter=ref_niter,
                free_niter=[c["niter"] for c in r0["ref_calls"]], same=same), bad


def model_axis_sharded_phase(seed: int, smi: str) -> dict:
    """Phase 7a: ``model_axis_rank`` under ``torch.distributed.run
    --nproc_per_node=2`` (gloo, both ranks on the one card); the limits and
    the K1 entry. Returns the kernels-line entry of K1's sharded path."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={MA_WORLD}", str(ROOT / "chip_smoke.py"),
               f"--model-axis-rank={tmp}", f"--seed={seed}"]
        env = dict(os.environ, PYTHONPATH=python_path(ROOT), OMP_NUM_THREADS="4")
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=MA_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"7a: exit {run.returncode}\n{run.stdout[-4000:]}\n"
                                 f"{run.stderr[-4000:]}")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(MA_WORLD)]
    r0 = ranks[0]
    read, bad = model_axis_failures(ranks)
    say(f"model axis 7a, torch.distributed.run --nproc_per_node={MA_WORLD} ({MA_MESH}, gloo, "
        f"both ranks on the one card): 256 px bf16 UNet with remat, height-sharded; Free Hunch "
        f"with the d-sharded state; gaussian blur; batch {FULL_BATCH}, {MA_STEPS} Heun steps "
        f"({len(r0['calls'])} guided calls), on {smi}; the command {wall:.3f} s")
    say(f"  weights hash {r0['weights']}; the ranks' x0 bitwise equal: {read['same']}")
    say(f"  per guided call, sharded against the unsharded mechanism from the same inputs "
        f"and state: x0 relative RMS {[float(f'{e:.3g}') for e in read['errs']]} (limit "
        f"{MA_CALL_REL_RMS:g}); CG niter {read['niter']} vs {read['ref_niter']}")
    say(f"  free-running, sharded against unsharded: x0 relative RMS per call "
        f"{[float(f'{e:.3g}') for e in read['free']]}, CG niter {read['free_niter']}; final "
        f"sample {read['final']:.3g} (limit {MA_FINAL_REL_RMS:g})")
    for r in ranks:
        say(f"  rank {r['rank']}: wall per guided call "
            f"{[round(c['ms'], 3) for c in r['calls']]} ms (run {r['wall']:.3f} s); peak "
            f"{r['peak_gib']:.3f} GiB; covariance state {r['cov_bytes']} bytes (Ut "
            f"{r['cov_shape']}); collectives per call {[c['collectives'] for c in r['calls']]}, "
            f"bytes sent per call {[c['bytes'] for c in r['calls']]}; K1 sharded launches "
            f"{r['launches']} (hooks {r['hooks']}), unsharded K1 launches "
            f"{r['launches_unsharded']}")
    say(f"  unsharded on rank 0 alone: wall per guided call "
        f"{[round(c['ms'], 3) for c in r0['ref_calls']]} ms (run {r0['ref_wall']:.3f} s); "
        f"peak {r0['ref_peak_gib']:.3f} GiB; covariance state {r0['ref_cov_bytes']} bytes")
    rows = r0["gn_rows"]
    e = sum_entry(GNS_ENTRY, rows, ("ms", "stats_ms", "apply_ms", "plain_ms", "unsharded_ms"))
    say(f"  K1 sharded path at the {len(rows)} distinct shard shapes of one forward (calls x "
        f"ms; both ranks at once):")
    for calls, r in rows:
        say(f"    {calls:3d} x {r['shape']} {r['dtype']} silu={r['silu']}: err "
            f"{r['max_abs_err']:.3g} (limit {r['limit']:.3g}) sharded {r['ms']:.4f} (stats "
            f"{r['stats_ms']:.4f}, apply {r['apply_ms']:.4f}) plain {r['plain_ms']:.4f} "
            f"unsharded K1 at the whole shape {r['unsharded_ms']:.4f} bound "
            f"{max(r['bytes_ms'], r['ops_ms']):.4f}")
    say(f"  sum over one forward's {sum(c for c, _ in rows)} calls: sharded {e['ms']:.3f} ms "
        f"(stats entry {e['stats_ms']:.3f}, apply entry {e['apply_ms']:.3f}), plain "
        f"{e['plain_ms']:.3f}, the unsharded K1 at the whole shapes {e['unsharded_ms']:.3f}, "
        f"bound {e['bound_ms']:.3f} ms ({e['bound_by']})")
    driver_rows = [r for rk in ranks for r in rk["gn_rows_driver"]]
    err_driver = max(r["max_abs_err"] for r in driver_rows)
    say(f"  K1 sharded path at the {len(r0['gn_rows_driver'])} distinct shard shapes of 7b's "
        f"batch of {MA_DRIVER_IMAGES}, checked on both ranks: max abs err {err_driver:.3g} "
        f"(largest over the shapes of err / limit "
        f"{max(r['max_abs_err'] / r['limit'] for r in driver_rows):.3g})")
    if bad:
        raise AssertionError(f"7a: {bad}")
    entry = {k: e[k] for k in list(GNS_ENTRY) + ["max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by"]}
    entry.update(launches=r0["launches"]["stats"], launches_apply=r0["launches"]["apply"],
                 library_ms=None, stats_ms=e["stats_ms"], apply_ms=e["apply_ms"],
                 unsharded_ms=e["unsharded_ms"],
                 **{f"max_abs_err_batch_{MA_DRIVER_IMAGES}": err_driver})
    return entry


def no_halo(x: torch.Tensor, mg, dim: int = 2, sizes=None) -> torch.Tensor:
    """The planted fault of phase 7's controls, in place of
    ``parallel/collectives.py::halo_rows``: zero rows where the
    neighbours' halo rows belong."""
    z = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([z, x, z], dim=dim)


class CallKeeper:
    """Pass-through guidance mechanism that appends each call's first
    denoiser output (the UNet's, before any guidance) to ``kept["d"]``, its
    x0 to ``kept["x0"]`` (f32 on the host) and its CG count to
    ``kept["niter"]``."""

    def __init__(self, mech, kept: dict):
        self.mech, self.kept = mech, kept

    def init_state(self, batch, img_shape):
        return self.mech.init_state(batch, img_shape)

    def __call__(self, denoise, x_t, y, sigma, state):
        outs = []

        def keep(*a, **k):
            res = denoise(*a, **k)
            outs.append(res[0].detach().float().cpu())
            return res

        x0, state = self.mech(keep, x_t, y, sigma, state)
        self.kept["d"].append(outs[0])
        self.kept["x0"].append(x0.float().cpu())
        self.kept["niter"].append(torch.tensor(getattr(state, "cg_niter", 0)))
        return x0, state


@contextlib.contextmanager
def keeping_samples(kept: dict):
    """Keep the guided calls (``CallKeeper``) and each batch's final sample
    (``kept["x"]``) of the Evaluator's ``sample_loop``, or DDNM+'s final
    sample of each batch, in this process; the rank probe enters it in a
    rank under ``FH_SMOKE_SAMPLES``."""
    orig, orig_ddnm = teval.sample_loop, teval_ddnm.ddnm_sample

    def keep(denoise, mech, *a, **k):
        res = orig(denoise, CallKeeper(mech, kept), *a, **k)
        kept["x"].append(res[0].float().cpu())
        return res

    def keep_ddnm(*a, **k):
        res = orig_ddnm(*a, **k)
        kept["x"].append(res[0].float().cpu())
        return res

    teval.sample_loop, teval_ddnm.ddnm_sample = keep, keep_ddnm
    try:
        yield kept
    finally:
        teval.sample_loop, teval_ddnm.ddnm_sample = orig, orig_ddnm


def model_axis_driver_world(tmp: Path, argv: list, label: str, no_halo: bool = False) -> dict:
    """``torch.distributed.run --nproc_per_node=2 -m
    free_hunch_tpu_torch.generate_conditional argv --mesh_shape=MA_MESH``
    under the rank probe, in ``tmp / label``; with ``no_halo`` every 3x3
    conv of the torso takes zero rows in place of its neighbours' halos (a
    planted fault). Its results, probes, journals, each rank's guided
    calls' x0 and final samples (``samples``: one dict a rank) and wall."""
    d = tmp / label
    for sub in ("probe", "site"):
        (d / sub).mkdir(parents=True)
    (d / "site" / "sitecustomize.py").write_text(RANK_PROBE)
    out = d / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={MA_WORLD}", "-m", "free_hunch_tpu_torch.generate_conditional",
           *argv, f"--outdir={out}", f"--mesh_shape={MA_MESH}"]
    env = dict(os.environ, PYTHONPATH=python_path(d / "site", ROOT),
               FH_SMOKE_PROBE=str(d / "probe"), FH_SMOKE_SAMPLES="1", OMP_NUM_THREADS="4")
    if no_halo:
        env["FH_SMOKE_NO_HALO"] = "1"
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=MA_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"7b {label}: exit {run.returncode}\n{run.stdout[-4000:]}\n"
                             f"{run.stderr[-4000:]}")
    results, _ = check_artifacts(out, f"7b {label}", MA_DRIVER_IMAGES, 1, fid=False)
    return dict(
        results=results, wall=wall,
        probes=[json.loads((d / "probe" / f"rank{r}.json").read_text()) for r in range(MA_WORLD)],
        journals=sorted(p.name for p in out.glob("metrics_rank*.jsonl")),
        samples=[{k: [t.numpy() for t in v]
                  for k, v in torch.load(d / "probe" / f"rank{r}_x.pt").items()}
                 for r in range(MA_WORLD)])


def model_axis_driver_phase(seed: int, smi: str, control: bool = False) -> dict:
    """Phase 7b: ``torch.distributed.run --nproc_per_node=2 -m
    free_hunch_tpu_torch.generate_conditional --mesh_shape=data:1,model:2``
    on two bundled images, 5 Heun steps, batch 2; then the same command as
    a world of one. With ``control`` also the model-axis run without halos,
    which must break the limits. Returns each rank's K1 sharded launches."""
    argv = driver_args(seed) + [
        "--conditioning_mechanism=online_covariance", "--image_base_covariance=dct_diagonal",
        "--operator_name=gaussian_blur", "--kernel_size=61", "--intensity=3.0",
        f"--num_steps={MA_DRIVER_STEPS}", "--cov_capacity=auto",
        f"--total_images={MA_DRIVER_IMAGES}", f"--batch_size={MA_DRIVER_IMAGES}",
        f"--num_other_images_to_save={MA_DRIVER_IMAGES}"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ma = model_axis_driver_world(tmp, argv, "model_axis")
        t0 = time.perf_counter()
        with keeping_samples({"d": [], "x0": [], "x": [], "niter": []}) as kept:
            one = cmdline(argv + [f"--outdir={tmp / 'one'}"], device="cuda")
        wall_one = time.perf_counter() - t0
        one["samples"] = {k: [t.numpy() for t in v] for k, v in kept.items()}
        fault = model_axis_driver_world(tmp, argv, "no_halo", no_halo=True) if control else None
    results, probes = ma["results"], ma["probes"]
    read = model_axis_driver_readings(ma, one)
    say(f"model axis 7b, torch.distributed.run --nproc_per_node={MA_WORLD} generate_conditional "
        f"--mesh_shape={MA_MESH}, {MA_DRIVER_IMAGES} bundled images, {MA_DRIVER_STEPS} Heun "
        f"steps, batch {MA_DRIVER_IMAGES}, on {smi}:")
    say(f"  results: images {results['images']}, PSNR {results['psnr']:.4f}, SSIM "
        f"{results['ssim']:.4f}, LPIPS {results['lpips']:.4f} (proxy); journals "
        f"{ma['journals']}; the command {ma['wall']:.3f} s")
    say(f"  per rank: totals {[p.get('totals') for p in probes]}; peak "
        f"{[round(p['peak_gib'], 3) for p in probes]} GiB; K1 sharded launches "
        f"{[p['sharded'] for p in probes]} (hooks {[p['hooks'] for p in probes]}); unsharded "
        f"K1 {[p['launches'] for p in probes]}")
    say(f"  world of one: PSNR {one['psnr']:.4f}, SSIM {one['ssim']:.4f}, {wall_one:.3f} s; "
        f"|dPSNR| {read['d_psnr']:.4g} dB (limit {MA_PSNR_ABS}), |dSSIM| {read['d_ssim']:.4g} "
        f"(limit {MA_SSIM_ABS})")
    say(f"  against the world of one's, relative RMS: the first guided call's denoiser "
        f"output, from equal inputs, {read['denoised']:.3g} (limit {MA_DENOISED_REL_RMS:g}); "
        f"x0 per guided call {[float(f'{e:.3g}') for e in read['calls']]}; final samples "
        f"{read['final']:.4g}; CG niter {read['niter']}; the ranks' outputs bitwise equal: "
        f"{read['same']}")
    bad = model_axis_driver_failures(results, probes, ma["journals"], one, read)
    if fault is not None:
        fread = model_axis_driver_readings(fault, one)
        fbad = model_axis_driver_failures(fault["results"], fault["probes"], fault["journals"],
                                          one, fread)
        say(f"  control, the same command with zero rows for every halo: |dPSNR| "
            f"{fread['d_psnr']:.4g} dB, |dSSIM| {fread['d_ssim']:.4g}, the first denoiser "
            f"output {fread['denoised']:.3g}, x0 per guided call "
            f"{[float(f'{e:.3g}') for e in fread['calls']]}, final samples "
            f"{fread['final']:.4g}; the limits it breaks: {fbad}; the command "
            f"{fault['wall']:.3f} s")
        if not any("denoiser output" in b for b in fbad):
            bad.append("the control without halos reads inside the denoiser's limit")
    if bad:
        raise AssertionError(f"7b: {bad}")
    return {f"launches_driver_model_axis_rank{p['rank']}": p["sharded"]["stats"] for p in probes}


def model_axis_driver_readings(ma: dict, one: dict) -> dict:
    """7b's distances from the world of one: |dPSNR|, |dSSIM|, and the
    relative RMS of rank 0's first denoiser output, x0 at each guided call
    and final samples from the world of one's; and whether the ranks'
    outputs are bitwise equal."""
    s0, s1 = ma["samples"][0], one["samples"]
    return dict(d_psnr=abs(ma["results"]["psnr"] - one["psnr"]),
                d_ssim=abs(ma["results"]["ssim"] - one["ssim"]),
                denoised=rel_rms_err(s0["d"][0], s1["d"][0]),
                calls=[rel_rms_err(a, b) for a, b in zip(s0["x0"], s1["x0"])],
                final=rel_rms_err(np.concatenate(s0["x"]), np.concatenate(s1["x"])),
                n_calls=(len(s0["x0"]), len(s1["x0"])),
                niter=([int(n) for n in s0["niter"]], [int(n) for n in s1["niter"]]),
                same=all(len(r["x0"]) == len(s0["x0"]) and
                         all(np.array_equal(a, b) for k in ("d", "x0", "x")
                             for a, b in zip(r[k], s0[k])) for r in ma["samples"][1:]))


def model_axis_driver_failures(results: dict, probes: list, journals: list, one: dict,
                               read: dict) -> list:
    """What breaks 7b's limits: each image counted once, one journal, the
    ranks' totals equal and finite, their outputs bitwise equal, as many
    guided calls as the world of one (``one``) and the first call's
    denoiser output, from the same inputs, within ``MA_DENOISED_REL_RMS``
    of its,
    PSNR and SSIM within ``MA_PSNR_ABS`` and ``MA_SSIM_ABS`` of its, and
    each rank's K1 stats and apply launches equal to its GroupNorm32
    hooks."""
    totals = [p.get("totals") for p in probes]
    bad = []
    if results["images"] != MA_DRIVER_IMAGES or journals != ["metrics_rank00.jsonl"]:
        bad.append(f"images {results['images']}, journals {journals}")
    if any(t != totals[0] for t in totals) or \
            not all(np.isfinite(v) for v in totals[0].values()):
        bad.append(f"the ranks' totals {totals}")
    if not read["same"]:
        bad.append("the ranks' outputs differ")
    if read["n_calls"][0] != read["n_calls"][1]:
        bad.append(f"guided calls {read['n_calls']}")
    if not read["denoised"] <= MA_DENOISED_REL_RMS:
        bad.append(f"first denoiser output relative RMS {read['denoised']}")
    if not (read["d_psnr"] <= MA_PSNR_ABS and read["d_ssim"] <= MA_SSIM_ABS):
        bad.append(f"|dPSNR| {read['d_psnr']}, |dSSIM| {read['d_ssim']}")
    for p in probes:
        sh = p["sharded"]
        if not (0 < sh["stats"] == sh["apply"] == p["hooks"]) or p["launches"] != 0:
            bad.append(f"rank {p['rank']}: K1 sharded launches {sh}, hooks {p['hooks']}, "
                       f"unsharded {p['launches']}")
    return bad


def model_axis_phase(seed: int, smi: str, control: bool = False) -> dict:
    """Phase 7 (7a, then 7b; ``control``: 7b's run without halos too); K1's
    sharded kernels-line entry."""
    entry = model_axis_sharded_phase(seed, smi)
    entry.update(model_axis_driver_phase(seed, smi, control))
    return entry


# -- phases 7c-7e: the model axis's remainders ----------------------------------

# 7c, the fused int8 torso at model:2, each guided call teacher-forced
# against rank 0's unsharded int8 replay. Sharded and unsharded quantise
# with the same merged scales, but their GroupNorm statistics sum in
# another order and cuDNN takes other algorithms for the first and last
# convs on the half-height shapes, so bf16 rounding flips an int8 code now
# and then, and a flipped code moves the per-sample abs-max and every later
# code: the 32 px int8 reference (INT8_REF_LIMITS) reads 1-7 % for a 1e-6
# change of the input. So each call is held to that reference's per-step
# limit, 5e-2; a rank that quantises with its own abs-max moves each call's
# input to every int8 layer by up to the ratio of the two scales.
MA_INT8_CALL_REL_RMS = 5e-2
# 7c's depth: 2 Heun steps, 3 guided calls (with 3 steps the whole script
# read 541.9 s on an H100 80GB HBM3 at 700 W, and 695.7 s on a slower host;
# PERF.md section 6)
MA_INT8_STEPS = 2
# K2's shard entries against their plain twin: codes equal except at ties
# (one step, at most this share of the codes) and the scale to 1e-6
# relative, as the unsharded K2 against its plain version (check_gn_quant)
K2S_CODE_FRAC, K2S_SCALE_REL = 1e-4, 1e-6
# 7d, ragged shards: data:1,model:3, the 256 px bf16 UNet (256 rows as 96,
# 96, 64 down to 8 as 3, 3, 2) at batch 2, against rank 0's unsharded
# model. The forwards, the denoiser's output at the schedule's first sigma
# (7b's first guided call) and the raw UNet's at t = 10 and 700, within
# MA_DENOISED_REL_RMS. The raw UNet's vjp within the larger of that and
# twice the unsharded bf16 torso's own distance from the f32 one on the
# same input, measured in the run: on the H100 the bf16 torso alone reads
# 5.8e-3 from f32 on that vjp and 0.136 on the denoiser's vjp at sigma 80
# (whose x - sigma F cancels), against 5.73e-3 and 0.0901 sharded against
# unsharded (PERF.md section 6), so no bf16 vjp holds 5e-3, and the
# denoiser's vjp is not taken. A shard without halos reads 0.08-0.28 on
# each (32 px, the CPU in f32: tests/test_torch_chip_smoke_model_axis_remainders.py).
MA_RAGGED_MESH, MA_RAGGED_WORLD, MA_RAGGED_BATCH = "data:1,model:3", 3, 2
# 7e, DDNM+ through the driver at data:1,model:2 against the world of one,
# --num_steps=5 (the entry doubles DDNM+'s steps, as the JAX script does:
# 10): no guidance amplifies the denoiser's difference (7b's first call:
# 1.64e-3 relative RMS), so the final samples are held to twice 7b's
# denoiser limit, 1e-2
MA_DDNM_STEPS, MA_DDNM_REL_RMS = 5, 1e-2
GNQS_ENTRY = dict(name="gn_silu_quant_sharded", route="cuda",
                  source="free_hunch_tpu_torch/csrc/gn_quant.cu",
                  replaces="free_hunch_tpu/ops/pallas_gn_quant.py:140")
K3H_ENTRY = dict(name="int8_conv_halo", route="cuda",
                 source="free_hunch_tpu_torch/csrc/int8_conv.cu",
                 replaces="free_hunch_tpu/ops/quant.py:96")


def sharded_int8_shapes(model, batch: int, res: int, dev="cuda"):
    """K2 shard shapes ((NHWC shape of this rank, the ranks' rows), dtype)
    -> calls over one no-grad forward of a height-sharded int8 model, and
    K3 shapes (input, weights, padding, output dtype) -> calls over that
    forward and one vjp (forward with grad, remat recomputes and
    pullbacks). The ranks' rows come from
    the model's plan at the level of the call's width (W halves each
    level), so every rank lists the same keys in the same order."""
    k2, k3 = Counter(), Counter()
    card = torch.device(dev).type == "cuda"
    name2 = "gn_silu_quant_sharded_cuda" if card else "gn_silu_quant_sharded_plain"
    orig2, orig3 = getattr(gq, name2), q.int8_conv_cuda

    def rows_of(w):
        return model._shard.plan.rows[int(round(np.log2(res / w)))]

    forward = [True]  # K2 counts the no-grad forward's calls only

    def rec2(x, g, b, groups, eps, mg, *a):
        if forward[0]:
            k2[(tuple(x.shape), rows_of(x.shape[2]), x.dtype)] += 1
        return orig2(x, g, b, groups, eps, mg, *a)

    def rec3(xq, wk, ascale, wscale, pad, out_dtype=torch.float32, stride=1):
        k3[(tuple(xq.shape), tuple(wk.shape), q._pads(pad), out_dtype)] += 1
        return orig3(xq, wk, ascale, wscale, pad, out_dtype, stride)

    x = torch.zeros((batch, 3, res, res), device=dev)
    t = torch.full((batch,), 500.0, device=dev)
    setattr(gq, name2, rec2)
    q.int8_conv_cuda = rec3
    try:
        with torch.no_grad():
            model(x, t)
        forward[0] = False
        xg = x.clone().requires_grad_(True)
        out = model(xg, t)
        torch.autograd.grad(out, xg, torch.ones_like(out))
        sync(dev)
    finally:
        setattr(gq, name2, orig2)
        q.int8_conv_cuda = orig3
    return k2, k3


@contextlib.contextmanager
def own_abs_max(on: bool):
    """The planted fault of 7c's control, while ``on``: the max-merge of
    ``parallel/collectives.py::all_max`` leaves each rank its own value."""
    from free_hunch_tpu_torch.parallel import collectives as coll
    orig = coll.all_max
    if on:
        coll.all_max = lambda t, mg: t
    try:
        yield
    finally:
        coll.all_max = orig


def check_gn_quant_sharded(shape, rows, dtype, mg, reps=5, dev="cuda") -> dict:
    """K2's shard entries (stats, the gather, merge, apply; with ``full``
    the flagged route: the full abs-max pass and the max-merge) against
    ``gn_silu_quant_sharded_plain`` on this rank's rows of one whole tensor
    drawn alike on every rank: codes equal except at ties (one step, at
    most ``K2S_CODE_FRAC`` of them), scales within ``K2S_SCALE_REL``. The
    control, the flagged route with each rank's own abs-max, is read, not
    held (the phase holds it across the ranks). Times, the ranks at once:
    the sharded path, each entry, the plain twin, the bytes bound. On the
    CPU (a rehearsal) the plain twin stands in for the kernels."""
    n, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(n * sum(rows) * w * c + 7)
    full_x = (torch.randn((n, sum(rows), w, c), generator=gen, device=dev) * 2
              + 0.5).to(dtype)
    start = sum(rows[:mg.model_index])
    x = full_x[:, start:start + h].contiguous()
    g = torch.randn((n, c), generator=gen, device=dev) * 0.2 + 1
    b = torch.randn((n, c), generator=gen, device=dev) * 0.2
    wq, ws = gq.gn_silu_quant_sharded_plain(x, g, b, 32, 1e-5, mg)
    row = dict(shape=shape, rows=rows, dtype=str(dtype).replace("torch.", ""))
    for route, full in (("", False), ("_full", True), ("_control", True)):
        with own_abs_max(route == "_control"):
            if x.is_cuda:
                xq, sc = gq.gn_silu_quant_sharded_cuda(x, g, b, 32, 1e-5, mg, full)
            else:
                xq, sc = gq.gn_silu_quant_sharded_plain(x, g, b, 32, 1e-5, mg)
        sync(dev)
        d = (xq.int() - wq.int()).abs()
        row.update({f"code_diff{route}": int(d.max()) if d.numel() else 0,
                    f"code_frac{route}": float((d > 0).float().mean()) if d.numel() else 0.0,
                    f"scale_rel{route}": float(((sc - ws).abs() / ws).max())})
    row["max_abs_err"] = float(max(row["code_diff"], row["code_diff_full"]))
    for route in ("", "_full"):
        if not (row[f"code_diff{route}"] <= 1 and row[f"code_frac{route}"] <= K2S_CODE_FRAC
                and row[f"scale_rel{route}"] <= K2S_SCALE_REL):
            raise AssertionError(f"sharded gn_silu_quant {shape} rows {rows}{route}: {row}")
    if not reps:
        return row
    from free_hunch_tpu_torch.parallel import collectives as coll
    part = gq.shard_quant_stats_cuda(x)
    parts = coll.gather_replicated(part[None], 0, mg).contiguous()
    work, _, amax = gq.shard_quant_merge_cuda(x, parts, g, b)
    nbytes = x.numel() * (x.element_size() + 1) + 2 * n * c * 4 + n * 4
    row.update(
        full_x=full_x, g=g, b=b,
        ms=time_ms(lambda: gq.gn_silu_quant_sharded_cuda(x, g, b, 32, 1e-5, mg), reps),
        stats_ms=time_ms(lambda: gq.shard_quant_stats_cuda(x), reps),
        merge_ms=time_ms(lambda: gq.shard_quant_merge_cuda(x, parts, g, b), reps),
        apply_ms=time_ms(lambda: gq.shard_quant_apply_cuda(x, work, amax, g, b), reps),
        plain_ms=time_ms(lambda: gq.gn_silu_quant_sharded_plain(x, g, b, 32, 1e-5, mg),
                         max(2, reps // 2)),
        bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        ops_ms=GNQ_FLOPS_PER_ELEM * x.numel() / F32_FLOP_PER_S * 1e3)
    return row


def check_int8_conv_halo(xs, ws, pad, out_dtype, gen, reps=5) -> dict:
    """K3 at one shape of a height shard (a halo'd 3x3 site takes padding
    (0, 1)): the int32 sums bitwise ``int8_conv_plain``'s, the output its
    epilogue's; eager ms, the plain version's and ``torch._int_mm``'s on an
    im2col (the same sums; timed only), the bound."""
    n, o, kh, kw = xs[0], ws[0], ws[1], ws[2]
    xq = torch.randint(-127, 128, xs, generator=gen, device="cuda", dtype=torch.int8)
    wk = torch.randint(-127, 128, ws, generator=gen, device="cuda", dtype=torch.int8)
    asc = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
    wsc = torch.rand(o, generator=gen, device="cuda") * 1e-3 + 1e-4
    acc = q.int8_conv_cuda(xq, wk, None, None, pad, torch.int32)
    want = q.int8_conv_plain(xq, wk, None, None, pad, torch.int32)
    out = q.int8_conv_cuda(xq, wk, asc, wsc, pad, out_dtype)
    torch.cuda.synchronize()
    if not (torch.equal(acc, want) and torch.equal(out, q._epilogue(want, asc, wsc,
                                                                    out_dtype))):
        raise AssertionError(f"int8_conv kernel {xs} x {ws} pad {pad}: not bitwise the "
                             f"plain version")
    cols = im2col(xq, kh, kw, pad)
    bmat = wk.reshape(o, -1).t()
    try:
        library_ms = time_ms(lambda: torch._int_mm(cols, bmat), reps)
    except RuntimeError:
        library_ms = None
    del cols
    m = acc.shape[0] * acc.shape[1] * acc.shape[2]
    ops = 2 * m * o * kh * kw * xs[-1]
    nbytes = xq.numel() + wk.numel() + m * o * out.element_size() + 4 * (n + o)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OP_PER_S * 1e3
    return dict(max_abs_err=0.0, library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                ms=time_ms(lambda: q.int8_conv_cuda(xq, wk, asc, wsc, pad, out_dtype), reps),
                plain_ms=time_ms(lambda: q.int8_conv_plain(xq, wk, asc, wsc, pad, out_dtype),
                                 1))


class LaunchHooks:
    """Counts, over a run, the module calls that launch the kernels of the
    sharded int8 torso: GroupNorm32 calls (K1's shard entries), fused
    QuantConv calls (``gn=``: K2's), calls of every int8 module and the
    int8 pullbacks (K3's)."""

    def __init__(self, model):
        self.calls = Counter()

        def hook(mod, args, kwargs):
            if isinstance(mod, GroupNorm32):
                self.calls["gn"] += 1
            else:
                self.calls["int8"] += 1
                if kwargs.get("gn") is not None:
                    self.calls["gnq"] += 1

        self.hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
                      for m in model.modules()
                      if isinstance(m, (GroupNorm32, q.QuantConv, q.QuantDense))]
        self.orig_pb = q._int8_pullback

        def pullback(*a, **k):
            self.calls["pullback"] += 1
            return self.orig_pb(*a, **k)

        q._int8_pullback = pullback

    def close(self):
        for h in self.hooks:
            h.remove()
        q._int8_pullback = self.orig_pb
        return dict(self.calls)


def int8_axis_rank(outdir: Path, seed: int, dev: str = "cuda", setup: Path = None,
                   batch: int = FULL_BATCH, steps: int = MA_INT8_STEPS) -> None:
    """Phase 7c, one rank of ``torch.distributed.run --nproc_per_node=2``:
    the 256 px fused-int8 UNet (``quant="int8"``, ``fused_gn_quant``,
    remat) height-sharded over ``MA_MESH``. On the card, K2's shard entries
    at every distinct shard shape of one forward against their plain twin
    (with the flagged route and the per-rank abs-max control), timed against
    the unsharded K2 at the whole shape (rank 0 alone), and K3 at every
    distinct shape of one sharded forward and vjp against its plain
    version. Then Free Hunch with the d-sharded state (7a's slice: gaussian
    blur, capacity 34, batch 8, ``steps`` Heun steps), each kernel's
    launches against the hooks; rank 0 replays each guided call with the
    unsharded int8 model from the sharded run's inputs and gathered state.
    Writes ``int8_rank<r>.pt``."""
    from free_hunch_tpu_torch.parallel import collectives as coll
    from free_hunch_tpu_torch.parallel import dist, mesh
    dist.init()
    mg = mesh.make_model_groups(MA_MESH)
    rank = dist.get_rank()
    card = torch.device(dev).type == "cuda"
    setup = SETUP_256 if setup is None else setup
    qkw = dict(quant="int8", fused_gn_quant=True)
    model, model_args = loading.load_model(
        str(CKPT_256), str(setup), dtype=torch.bfloat16, init_random_if_missing=True,
        rng_seed=seed, remat=True, device=dev, model_group=mg, **qkw)
    res = model_args["image_size"]
    out = dict(rank=rank, k2_rows=[], k3_rows=[])
    k2_shapes, k3_shapes = sharded_int8_shapes(model, batch, res, dev)
    rows = [(calls, check_gn_quant_sharded(shape, rws, dtype, mg, reps=5 if card else 0,
                                           dev=dev))
            for (shape, rws, dtype), calls in sorted(
                k2_shapes.items(), key=lambda kv: kv[0][1:2] + (kv[0][0][2:],))]
    out["k2_rows"] = rows
    if card:
        dist.barrier()
        if rank == 0:  # the unsharded K2 at the same whole shapes, this rank alone
            for _, r in rows:
                r["unsharded_ms"] = time_ms(lambda: gq.gn_silu_quant_cuda(
                    r["full_x"], r["g"], r["b"]), 5)
        dist.barrier()
        out["k2_rows"] = [(calls, {k: v for k, v in r.items() if k not in ("full_x", "g", "b")})
                          for calls, r in rows]
        del rows
        gen = torch.Generator(device="cuda").manual_seed(seed + 3)
        out["k3_rows"] = [(calls, dict(xs=xs, ws=ws, pad=pad, out=str(od),
                                       **check_int8_conv_halo(xs, ws, pad, od, gen)))
                          for (xs, ws, pad, od), calls in sorted(
                              k3_shapes.items(), key=lambda kv: -np.prod(kv[0][0]))]
        torch.cuda.empty_cache()

    precond = loading.wrap_precond(model, model_args)
    op = slice_operator("gaussian_blur", res, dev, seed)
    xs, s0 = schedule(precond, steps)
    gen = torch.Generator().manual_seed(seed)
    cond = (torch.rand((batch, 3, res, res), generator=gen) * 2 - 1).to(dev)
    y = op.forward(cond, generator=torch.Generator().manual_seed(seed + 1))
    noise = torch.randn((batch, 3, res, res), generator=gen).to(dev)
    mech = ShardedCallRecorder(free_hunch(op, res, MA_CAP, "dct_diagonal", model_group=mg),
                               dev, keep_inputs=True)
    hooks = LaunchHooks(model)
    sync(dev)
    if card:
        torch.cuda.reset_peak_memory_stats()
    gn.sharded_launches.update(stats=0, apply=0)
    gq.sharded_launches.update(stats=0, merge=0, apply=0)
    zero_counts()
    coll.reset_counts()
    t0 = time.perf_counter()
    x, _, _ = edm.sample_loop(precond, mech, noise, y, xs, sigma0_scaled=s0,
                              collect_diagnostics=True)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(k1=dict(gn.sharded_launches), k2=dict(gq.sharded_launches),
                    **counts())
    out.update(wall=wall, hooks=hooks.close(), launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if card else 0.0,
               x=x.cpu().numpy(), collectives=dict(coll.counts),
               calls=[{k: c[k] for k in ("ms", "x0", "niter", "collectives", "bytes")}
                      for c in mech.calls])
    inputs = [{k: c[k] for k in ("x_t", "sigma", "state")} for c in mech.calls]
    state = model.state_dict()
    del model, precond, mech
    dist.barrier()
    if rank == 0:  # each guided call unsharded from the sharded run's inputs
        with torch.device(dev):
            ref = create_model(dtype=torch.bfloat16, remat=True, **qkw, **model_args)
        ref.load_state_dict(state)
        del state
        pre_ref = loading.wrap_precond(ref.eval().requires_grad_(False), model_args)
        forced = free_hunch(op, res, MA_CAP, "dct_diagonal")
        out["forced"] = []
        for c in inputs:
            x0, st = forced(pre_ref, c["x_t"].to(dev), y, c["sigma"], state_to(c["state"], dev))
            out["forced"].append(dict(x0=x0.cpu().numpy(), niter=st.cg_niter))
    torch.save(out, outdir / f"int8_rank{rank}.pt")
    dist.barrier()
    dist.destroy()


def ragged_axis_rank(outdir: Path, seed: int, dev: str = "cuda", setup: Path = None,
                     batch: int = MA_RAGGED_BATCH, dtype=torch.bfloat16) -> None:
    """Phase 7d, one rank of ``torch.distributed.run --nproc_per_node=3``:
    the 256 px bf16 UNet with remat, height-sharded over ``MA_RAGGED_MESH``,
    ragged at every level. On the card, K1's shard entries (whose apply
    merges the ranks' partials weighted by their counts) against their plain
    twin at every distinct ragged shard shape of one forward, timed; then
    one forward and one vjp at ``batch``, K1's launches against the hooks;
    rank 0 runs both unsharded. Writes ``ragged_rank<r>.pt``. ``dev``,
    ``setup``, ``batch`` and ``dtype`` let the CPU rehearse it."""
    from free_hunch_tpu_torch.parallel import dist, mesh
    dist.init()
    mg = mesh.make_model_groups(MA_RAGGED_MESH)
    rank = dist.get_rank()
    card = torch.device(dev).type == "cuda"
    setup = SETUP_256 if setup is None else setup
    model, model_args = loading.load_model(
        str(CKPT_256), str(setup), dtype=dtype, init_random_if_missing=True,
        rng_seed=seed, remat=True, device=dev, model_group=mg)
    res = model_args["image_size"]
    out = dict(rank=rank, gn_rows=[])
    if card:
        shapes = gn_shard_shapes(model, batch, res)
        keys = sorted({(sh[0], int(round(np.log2(res / sh[2]))), sh[2], sh[3], dt, silu)
                       for sh, dt, silu in shapes}, key=lambda k: (k[1], k[3], str(k[4]), k[5]))
        calls = Counter()
        for (sh, dt, silu), n in shapes.items():
            calls[(sh[0], int(round(np.log2(res / sh[2]))), sh[2], sh[3], dt, silu)] += n
        plan = model._shard.plan
        for key in keys:
            n, level, w, c, dt, silu = key
            rows = plan.rows[level]
            r = check_gn_sharded((n, rows[rank], w, c), dt, silu, mg, reps=5, rows=rows)
            out["gn_rows"].append((calls[key], r))
    rng = np.random.default_rng(seed + 5)
    x = torch.as_tensor(rng.normal(size=(batch, 3, res, res)), dtype=torch.float32).to(dev)
    t = torch.tensor([10.0, 700.0][:batch] + [500.0] * max(0, batch - 2)).to(dev)
    w = torch.as_tensor(rng.normal(size=(batch, 6, res, res)), dtype=torch.float32).to(dev)
    xs, _ = schedule(loading.wrap_precond(model, model_args), MA_STEPS)
    sigma = float(xs["sigma_hat"][0])

    def run(net):
        """The denoiser's output at ``sigma`` from ``x * sigma`` (7b's first
        guided call), then the raw UNet's output and vjp at t."""
        with torch.no_grad():
            d = loading.wrap_precond(net, model_args)(x * sigma, sigma)[0]
            y = net(x, t)
        xg = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((net(xg, t) * w).sum(), xg)
        return {k: v.float().cpu().numpy() for k, v in dict(d=d, y=y, gx=gx).items()}

    hooks = [0]
    handles = [m.register_forward_pre_hook(lambda mod, a: hooks.__setitem__(0, hooks[0] + 1))
               for m in model.modules() if isinstance(m, GroupNorm32)]
    gn.sharded_launches.update(stats=0, apply=0)
    zero_counts()
    sync(dev)
    t0 = time.perf_counter()
    out.update(run(model))
    sync(dev)
    out.update(wall=time.perf_counter() - t0, hooks=hooks[0], sigma=sigma,
               launches=dict(gn.sharded_launches),
               launches_unsharded=counts()["groupnorm_silu"], plan=model._shard.plan.rows)
    for h in handles:
        h.remove()
    state = model.state_dict()
    del model
    dist.barrier()
    if rank == 0:  # unsharded, and unsharded in f32 (the torso dtype's own distance)
        for key, dt in (("ref", dtype), ("f32", torch.float32)):
            if dt == dtype and key == "f32":
                out[key] = out["ref"]
                continue
            with torch.device(dev):
                ref = create_model(dtype=dt, remat=True, **model_args)
            ref.load_state_dict(state)
            out[key] = run(ref.eval().requires_grad_(False))
            del ref
    torch.save(out, outdir / f"ragged_rank{rank}.pt")
    dist.barrier()
    dist.destroy()


def run_ranks(part: str, world: int, seed: int) -> tuple:
    """``torch.distributed.run --nproc_per_node=world chip_smoke.py
    --model-axis-rank=<dir> --model-axis-part=part``: each rank's output
    and the command's wall."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={world}", str(ROOT / "chip_smoke.py"),
               f"--model-axis-rank={tmp}", f"--model-axis-part={part}", f"--seed={seed}"]
        env = dict(os.environ, PYTHONPATH=python_path(ROOT), OMP_NUM_THREADS="2")
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=MA_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"{part}: exit {run.returncode}\n{run.stdout[-4000:]}\n"
                                 f"{run.stderr[-4000:]}")
        name = {"7c": "int8", "7d": "ragged"}[part]
        return [torch.load(tmp / f"{name}_rank{r}.pt", weights_only=False)
                for r in range(world)], wall


def int8_axis_failures(ranks: list) -> tuple:
    """(readings, what breaks 7c's limits): each guided call's x0 against
    rank 0's unsharded replay (``MA_INT8_CALL_REL_RMS``) with equal CG
    counts, the ranks' x0 bitwise equal and finite, each rank's launches
    against its hooks (K1's stats = apply = GroupNorm32 calls, K2's stats =
    merge = apply = fused calls, K3 = int8 calls + pullbacks, no unsharded
    K1 or K2), and the per-rank abs-max control outside K2's scale limit on
    some rank at every K2 shape."""
    r0 = ranks[0]
    errs = [rel_rms_err(c["x0"], f["x0"]) for c, f in zip(r0["calls"], r0["forced"])]
    niter = [c["niter"] for c in r0["calls"]]
    ref_niter = [f["niter"] for f in r0["forced"]]
    same = all(np.array_equal(c["x0"], c1["x0"])
               for r in ranks[1:] for c, c1 in zip(r0["calls"], r["calls"]))
    bad = [f"call {i}: x0 relative RMS {e:.3g}" for i, e in enumerate(errs)
           if not e <= MA_INT8_CALL_REL_RMS]
    if niter != ref_niter or len(errs) != len(r0["calls"]):
        bad.append(f"CG niter {niter} vs {ref_niter}")
    if not same or not np.isfinite(r0["x"]).all():
        bad.append("the ranks' x0 differ, or the sample is not finite")
    for r in ranks:
        la, hk = r["launches"], r["hooks"]
        if not (0 < la["k1"]["stats"] == la["k1"]["apply"] == hk.get("gn", 0)) or \
                not (0 < la["k2"]["stats"] == la["k2"]["merge"] == la["k2"]["apply"]
                     == hk.get("gnq", 0)) or \
                la["int8_conv"] != hk.get("int8", 0) + hk.get("pullback", 0) or \
                la["groupnorm_silu"] or la["gn_silu_quant"]:
            bad.append(f"rank {r['rank']}: launches {la}, hooks {hk}")
    control = [max(rk["k2_rows"][i][1]["scale_rel_control"] for rk in ranks)
               for i in range(len(r0["k2_rows"]))]
    if control and not min(control) > K2S_SCALE_REL:
        bad.append(f"the per-rank abs-max control reads inside the scale limit: {control}")
    return dict(errs=errs, niter=niter, ref_niter=ref_niter, same=same,
                control=control), bad


def int8_axis_phase(seed: int, smi: str) -> tuple:
    """Phase 7c (``int8_axis_rank`` on two ranks); the limits, and the
    kernels-line entries of K2's shard entries and of K3 on the shards."""
    ranks, wall = run_ranks("7c", MA_WORLD, seed)
    read, bad = int8_axis_failures(ranks)
    r0 = ranks[0]
    say(f"model axis 7c, torch.distributed.run --nproc_per_node={MA_WORLD} ({MA_MESH}, gloo, "
        f"both ranks on the one card): 256 px fused-int8 UNet with remat, height-sharded; "
        f"Free Hunch with the d-sharded state; gaussian blur; batch {FULL_BATCH}, "
        f"{MA_INT8_STEPS} Heun steps ({len(r0['calls'])} guided calls), on {smi}; the command "
        f"{wall:.3f} s")
    say(f"  per guided call, sharded against rank 0's unsharded int8 replay from the same "
        f"inputs and state: x0 relative RMS {[float(f'{e:.3g}') for e in read['errs']]} "
        f"(limit {MA_INT8_CALL_REL_RMS:g}); CG niter {read['niter']} vs {read['ref_niter']}; "
        f"the ranks' x0 bitwise equal: {read['same']}")
    for r in ranks:
        say(f"  rank {r['rank']}: wall per guided call {[round(c['ms'], 3) for c in r['calls']]}"
            f" ms (run {r['wall']:.3f} s); peak {r['peak_gib']:.3f} GiB; collectives per call "
            f"{[c['collectives'] for c in r['calls']]}, bytes sent per call "
            f"{[c['bytes'] for c in r['calls']]}; launches {r['launches']}; hooks {r['hooks']}")
    k2 = r0["k2_rows"]
    e2 = sum_entry(GNQS_ENTRY, k2, ("ms", "stats_ms", "merge_ms", "apply_ms", "plain_ms",
                                    "unsharded_ms"))
    say(f"  K2's shard entries at the {len(k2)} distinct shard shapes of one forward (calls x "
        f"ms; both ranks at once; limits: codes off by one at ties on at most "
        f"{K2S_CODE_FRAC:g} of them, scale {K2S_SCALE_REL:g} relative):")
    for calls, r in k2:
        say(f"    {calls:3d} x {r['shape']} of rows {r['rows']} {r['dtype']}: codes off "
            f"{r['code_diff']} on {r['code_frac']:.3g}, scale {r['scale_rel']:.3g}; flagged "
            f"route {r['code_diff_full']} on {r['code_frac_full']:.3g}, scale "
            f"{r['scale_rel_full']:.3g}; control (own abs-max) scale "
            f"{max(rk['k2_rows'][k2.index((calls, r))][1]['scale_rel_control'] for rk in ranks):.3g}"
            f"; sharded {r['ms']:.4f} (stats {r['stats_ms']:.4f}, merge {r['merge_ms']:.4f}, "
            f"apply {r['apply_ms']:.4f}) plain {r['plain_ms']:.4f} unsharded K2 at the whole "
            f"shape {r['unsharded_ms']:.4f} bound {max(r['bytes_ms'], r['ops_ms']):.4f}")
    say(f"  sum over one forward's {sum(c for c, _ in k2)} calls: sharded {e2['ms']:.3f} ms "
        f"(stats {e2['stats_ms']:.3f}, merge {e2['merge_ms']:.3f}, apply {e2['apply_ms']:.3f}), "
        f"plain {e2['plain_ms']:.3f}, the unsharded K2 at the whole shapes "
        f"{e2['unsharded_ms']:.3f}, bound {e2['bound_ms']:.3f} ms ({e2['bound_by']})")
    k3 = r0["k3_rows"]
    e3 = sum_entry(K3H_ENTRY, k3, ("ms", "plain_ms"))
    lib = [r["library_ms"] for _, r in k3]
    e3["library_ms"] = None if None in lib else sum(c * r["library_ms"] for c, r in k3)
    say(f"  K3 at the {len(k3)} distinct shapes of one sharded forward and vjp, bitwise the "
        f"plain version (calls x ms):")
    for calls, r in k3:
        say(f"    {calls:3d} x {r['xs']} x {r['ws']} pad {r['pad']} -> {r['out']}: "
            f"{r['ms']:.4f} (_int_mm {r['library_ms']}) plain {r['plain_ms']:.3f} bound "
            f"{max(r['bytes_ms'], r['ops_ms']):.4f}")
    say(f"  K3 summed: {e3['ms']:.3f} ms, _int_mm {e3['library_ms']}, plain "
        f"{e3['plain_ms']:.3f}, bound {e3['bound_ms']:.3f} ms ({e3['bound_by']})")
    say(f"  control: K2's flagged route with each rank's own abs-max reads the scale "
        f"{[float(f'{c:.3g}') for c in read['control']]} off the twin's (limit "
        f"{K2S_SCALE_REL:g}; must be outside at every shape)")
    if bad:
        raise AssertionError(f"7c: {bad}")
    keys = ["max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"]
    k2e = {k: e2[k] for k in list(GNQS_ENTRY) + keys}
    k2e.update(library_ms=None,
               launches=r0["launches"]["k2"]["stats"], launches_merge=r0["launches"]["k2"]["merge"],
               launches_apply=r0["launches"]["k2"]["apply"], stats_ms=e2["stats_ms"],
               merge_ms=e2["merge_ms"], apply_ms=e2["apply_ms"],
               unsharded_ms=e2["unsharded_ms"],
               scale_rel=max(r["scale_rel"] for _, r in k2),
               control_scale_rel=min(read["control"]))
    k3e = {k: e3[k] for k in list(K3H_ENTRY) + keys}
    k3e.update(launches=r0["launches"]["int8_conv"], library_ms=e3["library_ms"])
    return k2e, k3e, {"launches_int8_axis": r0["launches"]["k1"]["stats"]}


def ragged_axis_phase(seed: int, smi: str) -> dict:
    """Phase 7d (``ragged_axis_rank`` on three ranks): the forward and the
    vjp within ``MA_DENOISED_REL_RMS`` of rank 0's unsharded ones, the
    ranks' outputs bitwise equal, K1's launches equal to the hooks; K1's
    ragged readings for its kernels-line entry."""
    ranks, wall = run_ranks("7d", MA_RAGGED_WORLD, seed)
    r0 = ranks[0]
    read, bad = ragged_axis_failures(ranks)
    rows = [row for _, row in r0["gn_rows"]]
    say(f"model axis 7d, torch.distributed.run --nproc_per_node={MA_RAGGED_WORLD} "
        f"({MA_RAGGED_MESH}, gloo, the ranks on the one card): 256 px bf16 UNet with remat, "
        f"rows a rank per level {r0['plan']}; one forward and one vjp at batch "
        f"{MA_RAGGED_BATCH}, on {smi}; the command {wall:.3f} s")
    say(f"  against rank 0's unsharded model, relative RMS: the denoiser at sigma "
        f"{r0['sigma']:g} {read['d']:.3g} (limit {MA_DENOISED_REL_RMS:g}); the raw UNet at t "
        f"= 10, 700 {read['y']:.3g} (limit {MA_DENOISED_REL_RMS:g}), its vjp "
        f"{read['gx']:.3g} (limit {read['gx_limit']:.3g}); the unsharded bf16 torso against "
        f"f32: denoiser {read['d_f32']:.3g}, raw {read['y_f32']:.3g}, raw vjp "
        f"{read['gx_f32']:.3g}; the ranks' outputs bitwise equal: {read['same']}; per rank: "
        f"wall {[round(r['wall'], 3) for r in ranks]} s, K1 sharded launches "
        f"{[r['launches'] for r in ranks]}, hooks {[r['hooks'] for r in ranks]}")
    e = sum_entry(GNS_ENTRY, r0["gn_rows"], ("ms", "stats_ms", "apply_ms", "plain_ms"))
    for calls, r in r0["gn_rows"]:
        say(f"    {calls:3d} x {r['shape']} of rows {r['rows']} {r['dtype']} silu={r['silu']}: "
            f"err {r['max_abs_err']:.3g} (limit {r['limit']:.3g}) sharded {r['ms']:.4f} (stats "
            f"{r['stats_ms']:.4f}, apply {r['apply_ms']:.4f}) plain {r['plain_ms']:.4f} bound "
            f"{max(r['bytes_ms'], r['ops_ms']):.4f}")
    say(f"  K1's count-weighted shard entries at the {len(rows)} distinct ragged shard shapes "
        f"of one forward: max err / limit {max(r['max_abs_err'] / r['limit'] for r in rows):.3g}"
        f"; summed over its {sum(c for c, _ in r0['gn_rows'])} calls {e['ms']:.3f} ms (stats "
        f"{e['stats_ms']:.3f}, apply {e['apply_ms']:.3f}), plain {e['plain_ms']:.3f}, bound "
        f"{e['bound_ms']:.3f} ms")
    if bad:
        raise AssertionError(f"7d: {bad}")
    return dict(launches_ragged=r0["launches"]["stats"],
                max_abs_err_ragged=max(r["max_abs_err"] for r in rows), ms_ragged=e["ms"],
                plain_ms_ragged=e["plain_ms"], bound_ms_ragged=e["bound_ms"])


def ragged_axis_failures(ranks: list) -> tuple:
    """(readings, what breaks 7d's limits): rank 0's denoiser output and
    raw UNet output within ``MA_DENOISED_REL_RMS`` of the unsharded ones,
    the raw UNet's vjp within the larger of that and twice the unsharded
    torso's distance from f32, the ranks' outputs bitwise equal, each
    rank's K1 stats and apply launches equal to its GroupNorm32 hooks, no
    unsharded K1 launch."""
    r0 = ranks[0]
    keys = ("d", "y", "gx")
    read = {k: rel_rms_err(r0[k], r0["ref"][k]) for k in keys}
    read.update({f"{k}_f32": rel_rms_err(r0["ref"][k], r0["f32"][k]) for k in keys})
    read["same"] = all(np.array_equal(r[k], r0[k]) for r in ranks[1:] for k in keys)
    read["gx_limit"] = max(MA_DENOISED_REL_RMS, 2 * read["gx_f32"])
    bad = []
    if not (read["d"] <= MA_DENOISED_REL_RMS and read["y"] <= MA_DENOISED_REL_RMS and
            read["gx"] <= read["gx_limit"]):
        bad.append(f"denoiser {read['d']}, raw UNet {read['y']}, its vjp {read['gx']} "
                   f"(limit {read['gx_limit']})")
    if not read["same"]:
        bad.append("the ranks' outputs differ")
    for r in ranks:
        if not (0 < r["launches"]["stats"] == r["launches"]["apply"] == r["hooks"]) or \
                r["launches_unsharded"]:
            bad.append(f"rank {r['rank']}: K1 launches {r['launches']}, hooks {r['hooks']}")
    return read, bad


def ddnm_axis_failures(ma: dict, one: dict, one_x: list) -> tuple:
    """(readings, what breaks 7e's limits): rank 0's final samples within
    ``MA_DDNM_REL_RMS`` of the world of one's (``one_x``), PSNR and SSIM
    within ``MA_PSNR_ABS`` and ``MA_SSIM_ABS`` of its (``one``), both
    images counted once in one journal, the ranks' samples bitwise equal,
    each rank's K1 stats and apply launches equal to its hooks."""
    probes, s0 = ma["probes"], ma["samples"][0]
    read = dict(final=rel_rms_err(np.concatenate(s0["x"]), np.concatenate(one_x)),
                same=all(len(r["x"]) == len(s0["x"]) and
                         all(np.array_equal(a, b) for a, b in zip(r["x"], s0["x"]))
                         for r in ma["samples"][1:]),
                d_psnr=abs(ma["results"]["psnr"] - one["psnr"]),
                d_ssim=abs(ma["results"]["ssim"] - one["ssim"]))
    bad = []
    if not (read["final"] <= MA_DDNM_REL_RMS and read["d_psnr"] <= MA_PSNR_ABS and
            read["d_ssim"] <= MA_SSIM_ABS):
        bad.append(f"samples {read['final']}, |dPSNR| {read['d_psnr']}, "
                   f"|dSSIM| {read['d_ssim']}")
    if ma["results"]["images"] != MA_DRIVER_IMAGES or \
            ma["journals"] != ["metrics_rank00.jsonl"] or not read["same"] or not s0["x"]:
        bad.append(f"images {ma['results']['images']}, journals {ma['journals']}, same "
                   f"{read['same']}")
    for p in probes:
        sh = p["sharded"]
        if not (0 < sh["stats"] == sh["apply"] == p["hooks"]) or p["launches"] != 0:
            bad.append(f"rank {p['rank']}: K1 sharded launches {sh}, hooks {p['hooks']}, "
                       f"unsharded {p['launches']}")
    return read, bad


def ddnm_axis_phase(seed: int, smi: str) -> dict:
    """Phase 7e: ``torch.distributed.run --nproc_per_node=2 -m
    free_hunch_tpu_torch.generate_conditional --conditioning_mechanism=ddnm
    --mesh_shape=data:1,model:2`` on two bundled images (inpainting, a
    fresh mask per image, ``--num_steps=MA_DDNM_STEPS``), then the same command as
    a world of one: the final samples within ``MA_DDNM_REL_RMS``, PSNR and
    SSIM within ``MA_PSNR_ABS`` and ``MA_SSIM_ABS``, one journal, the
    ranks' samples bitwise equal, each rank's K1 launches equal to its
    hooks."""
    argv = driver_args(seed) + [
        "--conditioning_mechanism=ddnm", "--operator_name=inpainting",
        f"--num_steps={MA_DDNM_STEPS}", f"--total_images={MA_DRIVER_IMAGES}",
        f"--batch_size={MA_DRIVER_IMAGES}", f"--num_other_images_to_save={MA_DRIVER_IMAGES}"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ma = model_axis_driver_world(tmp, argv, "ddnm_model_axis")
        t0 = time.perf_counter()
        with keeping_samples({"d": [], "x0": [], "x": [], "niter": []}) as kept:
            one = cmdline(argv + [f"--outdir={tmp / 'one'}"], device="cuda")
        wall_one = time.perf_counter() - t0
    probes = ma["probes"]
    read, bad = ddnm_axis_failures(ma, one, [t.numpy() for t in kept["x"]])
    final, same, d_psnr, d_ssim = read["final"], read["same"], read["d_psnr"], read["d_ssim"]
    say(f"model axis 7e, torch.distributed.run --nproc_per_node={MA_WORLD} generate_conditional "
        f"--conditioning_mechanism=ddnm --mesh_shape={MA_MESH}, {MA_DRIVER_IMAGES} bundled "
        f"images, inpainting, --num_steps={MA_DDNM_STEPS} ({2 * MA_DDNM_STEPS} DDNM+ steps), on "
        f"{smi}: the command {ma['wall']:.3f} s, "
        f"the world of one {wall_one:.3f} s; journals {ma['journals']}")
    say(f"  final samples against the world of one's, relative RMS {final:.4g} (limit "
        f"{MA_DDNM_REL_RMS:g}); |dPSNR| {d_psnr:.4g} dB (limit {MA_PSNR_ABS}), |dSSIM| "
        f"{d_ssim:.4g} (limit {MA_SSIM_ABS}); the ranks' samples bitwise equal: {same}; per "
        f"rank: peak {[round(p['peak_gib'], 3) for p in probes]} GiB, K1 sharded launches "
        f"{[p['sharded'] for p in probes]} (hooks {[p['hooks'] for p in probes]}), unsharded "
        f"{[p['launches'] for p in probes]}")
    if bad:
        raise AssertionError(f"7e: {bad}")
    return {f"launches_driver_ddnm_model_axis_rank{p['rank']}": p["sharded"]["stats"]
            for p in probes}


def model_axis_remainders(seed: int, smi: str) -> tuple:
    """Phases 7c-7e, each timed; returns the kernels-line entries of K2's
    shard entries and of K3 on the shards, and K1's readings."""
    with timed_phase("7c int8 torso on a height shard"):
        k2e, k3e, k1 = int8_axis_phase(seed, smi)
    with timed_phase("7d ragged shards"):
        k1.update(ragged_axis_phase(seed, smi))
    with timed_phase("7e DDNM+ under a model axis"):
        k1.update(ddnm_axis_phase(seed, smi))
    return k2e, k3e, k1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10, help="Heun steps of the 256 px "
                    "slices and the driver (DDNM+ takes twice as many); 10 keeps the "
                    "whole script well inside its time limit, the paper samples 30")
    ap.add_argument("--runs", type=int, default=1, help="sampling runs of the bf16 "
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
                    "and Free Hunch variant reference and the 256 px DDNM+ slices, then the "
                    "cost of the sampler's per-step draw by route; no result lines")
    ap.add_argument("--driver", action="store_true", help="phases 5a-5c alone: the 32 px "
                    "driver reference and generate_conditional at full width (Free Hunch, "
                    "then DDNM+ with 2 * --steps steps) on the bundled images; no result lines")
    ap.add_argument("--multiprocess", action="store_true", help="phases 5d and 5e alone: "
                    "the driver as a world of two ranks on the card (torch.distributed.run), "
                    "then kill and resume; no result lines")
    ap.add_argument("--vae", action="store_true", help="phase 6 alone: the SD-VAE at full "
                    "width on the bundled images, K1 at its norms; no result lines")
    ap.add_argument("--model-axis", action="store_true", help="phase 7 alone: the model axis "
                    "(data:1,model:2) as two ranks on the card, the sharded guided path "
                    "against the unsharded one and the driver, then 7c-7e; no result lines")
    ap.add_argument("--model-axis-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--model-axis-part", default="7a", choices=("7a", "7c", "7d"),
                    help=argparse.SUPPRESS)
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

    if args.model_axis_rank:  # one rank of phase 7a, 7c or 7d (torch.distributed.run)
        {"7a": model_axis_rank, "7c": int8_axis_rank, "7d": ragged_axis_rank}[
            args.model_axis_part](Path(args.model_axis_rank), args.seed)
        return 0

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
    if args.driver:
        driver_reference_phase(args.seed)
        driver_phase(args.seed, args.steps, smi)
        say(f"chip_smoke --driver wall time {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args.multiprocess:
        world2_phase(args.seed, args.steps, smi)
        kill_resume_phase(args.seed, args.steps, smi)
        say(f"chip_smoke --multiprocess wall time {time.perf_counter() - t_start:.1f} s "
            f"on {smi}")
        return 0
    if args.vae:
        vae_phase(args.seed, smi, layout=True)
        say(f"chip_smoke --vae wall time {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args.model_axis:
        model_axis_phase(args.seed, smi, control=True)
        model_axis_remainders(args.seed, smi)
        say(f"phase wall times (s): {json.dumps(PHASE_WALLS)}")
        say(f"chip_smoke --model-axis wall time {time.perf_counter() - t_start:.1f} s on {smi}")
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
        ddnm_draws_phase(model, model_args, 2 * args.steps, args.seed)
        say(f"chip_smoke --ddnm wall time {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    PHASE_WALLS["1 card and build"] = round(time.perf_counter() - t_start, 1)
    res = model_args["image_size"]
    with timed_phase("2 K1 kernels"):
        gn_entry = gn_kernel_phase(gn_shapes_of_forward(model, args.batch, res, "cuda"),
                                   {n: gn_shapes_of_forward(model, n, res, "cuda")
                                    for n in driver_batch_sizes() - {args.batch}})
    with timed_phase("3 reference"):
        reference_phase(args.seed)
    with timed_phase("3b mechanism reference"):
        mechanism_reference_phase(args.seed)
    with timed_phase("3c DDNM+ and variant reference"):
        ddnm_reference_phase(args.seed)
    with timed_phase("4 bf16 slice"):
        launches, walls = slice_phase(model, model_args, args.batch, args.steps, args.runs,
                                      args.seed, "bf16")
    say(f"bf16 sampling wall time per run (s): {[round(w, 3) for w in walls]} on {smi}")
    gn_entry["launches"] = launches["groupnorm_silu"]
    with timed_phase("4b-4d mechanisms"):
        for op_name, op_launches in mechanism_phases(model, model_args, args).items():
            gn_entry[f"launches_{op_name}"] = op_launches["groupnorm_silu"]
    # DDNM+ doubles the Heun step count, as generate_conditional.py does
    with timed_phase("4e DDNM+"):
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
    with timed_phase("2 K2 and K3 kernels"):
        k2_entry, k3_entry = int8_kernel_phase(*int8_shapes_of_forward(qmodel, args.batch,
                                                                       res, "cuda"))
    with timed_phase("3 int8 reference"):
        int8_reference_phase(args.seed)
    with timed_phase("4 int8 slice"):
        qlaunches, qwalls = slice_phase(qmodel, model_args, args.batch, args.steps, 1,
                                        args.seed, "fused int8")
    say(f"fused int8 sampling wall time per run (s): {[round(w, 3) for w in qwalls]} "
        f"on {smi}")
    k2_entry["launches"] = qlaunches["gn_silu_quant"]
    k3_entry["launches"] = qlaunches["int8_conv"]
    del qmodel
    torch.cuda.empty_cache()
    with timed_phase("5a driver reference"):
        driver_reference_phase(args.seed)
    with timed_phase("5b-5c driver"):
        for run_name, n in driver_phase(args.seed, args.steps, smi).items():
            gn_entry[f"launches_{run_name}"] = n
    with timed_phase("5d world of two"):
        gn_entry["launches_driver_world2"] = world2_phase(args.seed,
                                                          min(args.steps, MP_STEPS), smi)
    with timed_phase("5e kill and resume"):
        kill_resume_phase(args.seed, min(args.steps, MP_STEPS), smi)
    with timed_phase("6 VAE"):
        gn_entry.update(vae_phase(args.seed, smi))
    with timed_phase("7 model axis"):
        gns_entry = model_axis_phase(args.seed, smi)
    k2s_entry, k3h_entry, k1_readings = model_axis_remainders(args.seed, smi)
    gns_entry.update(k1_readings)
    say(f"groupnorm_silu launches: {launches['groupnorm_silu']} on the bf16 slice, "
        f"{qlaunches['groupnorm_silu']} on the int8 slice")
    for name, n in (("groupnorm_silu", launches["groupnorm_silu"]),
                    ("groupnorm_silu", gn_entry["launches_super_resolution"]),
                    ("groupnorm_silu", gn_entry["launches_inpainting"]),
                    *(("groupnorm_silu", gn_entry[f"launches_ddnm_{o}"]) for o in DDNM_OPS),
                    ("groupnorm_silu", qlaunches["groupnorm_silu"]),
                    ("groupnorm_silu", gn_entry["launches_driver"]),
                    ("groupnorm_silu", gn_entry["launches_driver_ddnm"]),
                    ("groupnorm_silu", gn_entry["launches_driver_world2"]),
                    ("groupnorm_silu", gn_entry["launches_vae"]),
                    ("gn_silu_quant", k2_entry["launches"]),
                    ("int8_conv", k3_entry["launches"]),
                    ("groupnorm_silu_sharded", gns_entry["launches"]),
                    *(("groupnorm_silu_sharded", v) for k, v in gns_entry.items()
                      if k.startswith(("launches_driver", "launches_int8_axis",
                                       "launches_ragged"))),
                    ("gn_silu_quant_sharded", k2s_entry["launches"]),
                    ("int8_conv_halo", k3h_entry["launches"])):
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its main path")
    say(f"phase wall times (s): {json.dumps(PHASE_WALLS)}")
    say(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [gn_entry, k2_entry, k3_entry, gns_entry, k2s_entry,
                                k3h_entry]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
