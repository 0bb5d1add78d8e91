"""GroupNorm(32)(+SiLU) over channels-last activations: the hand-written
Hopper kernel ``csrc/groupnorm.cu``, its plain PyTorch version, and the
autograd wrapper the UNet calls.

Replaces the TPU kernel ``free_hunch_tpu/ops/pallas_groupnorm.py``
(``_stats_kernel`` :70-85 and ``_apply_kernel`` :88-106, launched by
``_pallas_groupnorm`` :109-144, entry ``groupnorm_silu`` :166). It computes
that file's ``_reference`` (:38-59), with a centred variance instead of the
TPU kernel's ``E[x^2] - E[x]^2``.

Bound: device-memory bytes (~20 instructions per element against 4 or 8
bytes moved). The least traffic is one read of x and one write of y. A call
whose sample fits a thread-block cluster's shared memory (the 8-32 px calls
of the 256 px model) reads x once, in one launch; a larger one reads x
twice (statistics pass, then apply pass), because a whole sample's
statistics must be complete before any element is normalised and a sample
of up to 67 MB cannot stay on chip. ``gn_plan`` chooses the path from the
shape and says how often each reads x (``reads``). Every ``GroupNorm32`` of
the UNet lands here: 101 per forward of the 256 px model (42 ResBlocks x 2,
16 attention norms, the final norm), the largest on the (N, 256*256, 512)
bf16 decoder concat. ``chip_smoke.py`` counts the bytes of every call of
one forward from its shapes and prints the bound.

The gradient is the JAX package's ``custom_vjp`` (:147-163): no backward
kernel; the backward recomputes the plain version under autograd and pulls
the cotangent back through it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

# Calls that launched the CUDA kernel sequence (stats, finalize, apply; or
# the one cluster kernel). Plain-version calls on CPU tensors do not count.
launches = 0

# The streaming passes of K1 and K2 (csrc/gn_stats.cuh): blocks of about 256
# threads, each thread 16 bytes of a row and kUnroll = 4 rows in flight;
# about four blocks per SM in each pass. K2's chunks hold at least 16 rows,
# so its per-(chunk, channel) extrema stay a quarter of x's bytes or less.
_BLOCK_THREADS = 256
_BLOCKS_PER_SM = 4
_UNROLL = 4
_MIN_ROWS_QUANT = 16
# shared memory a block may take on Hopper (above 48 KB the kernel sets the
# attribute itself)
MAX_SHARED = 227 * 1024
# the one-launch path (csrc/gn_cluster.cuh): a cluster of at most 8 blocks
# (the portable size) holds a sample, each block its chunk of rows in at
# most 200 KB of dynamic shared memory (it also holds 20.5 KB of its own)
CLUSTER_BLOCKS = 8
CLUSTER_SMEM = 200 * 1024
_SMS: dict = {}


def device_sms(device) -> int:
    """The SM count of a CUDA device, read once (the planners of K1, K2 and
    K3 size their grids by it)."""
    sms = _SMS.get(device)
    if sms is None:
        idx = torch.device(device).index
        idx = torch.cuda.current_device() if idx is None else idx
        sms = _SMS[device] = torch.cuda.get_device_properties(idx).multi_processor_count
    return sms


class GNPlan(NamedTuple):
    """How K1 or K2 cuts one call: blocks of ``tx`` x ``ty`` threads (tx =
    C / vector width, each thread one 16-byte vector of a row), ``chunks``
    chunks of ``rows`` rows per sample, ``lanes`` lanes per group in the
    merge of the chunk partials, ``finals`` blocks per sample in K2's
    finalize; ``smem`` bytes of dynamic shared memory for the statistics
    pass, ``scratch`` f32 elements of scratch. ``path`` names the launch
    sequence; ``reads`` counts its reads of x."""
    tx: int
    ty: int
    rows: int
    chunks: int
    lanes: int
    finals: int
    smem: int
    scratch: int
    path: str
    reads: int


@functools.lru_cache(maxsize=4096)
def gn_plan(n: int, s: int, c: int, groups: int, itemsize: int, sms: int,
            quant: bool = False, path: Optional[str] = None) -> GNPlan:
    """K1's (``quant=False``) or K2's plan for n samples of s rows of c
    channels of ``itemsize`` bytes on a device with ``sms`` SMs. Whole
    C-wide rows per block, enough thread rows for about 256 threads.

    Where a sample's chunk of ceil(s / 8) rows and the statistics' shared
    memory fit one block's shared memory, the call takes the one-launch
    "cluster" path (one cluster of up to 8 blocks a sample; x read once).
    Otherwise the "two-pass" path (statistics, then one streaming pass over
    x: K1's apply, K2's quantise; K2's abs-max pass reads x only for a
    flagged sample): enough chunks per sample for about four blocks per SM
    (at most 1024), each at least one unrolled step of every thread row
    (K2: and 16 rows). ``path`` forces a path; the two-pass path forced
    where the cluster path fits is cut into the cluster path's chunks, so
    the two give bitwise equal results. Raises where the kernels cannot
    take the shape."""
    vec = 16 // itemsize
    if c % vec or c % groups:
        raise ValueError(f"groupnorm kernels: C={c} must be a multiple of groups={groups} "
                         f"and of {vec}")
    tx = c // vec
    if tx > 1024:
        raise ValueError(f"groupnorm kernels: C/{vec} = {tx} > 1024")
    ty = max(1, _BLOCK_THREADS // tx)
    part_smem = (2 * ty * c + ty) * 4
    cl_rows = -(-s // CLUSTER_BLOCKS)
    cl_smem = cl_rows * c * itemsize + part_smem
    fits = cl_smem <= CLUSTER_SMEM
    if path is None:
        path = "cluster" if fits else "two-pass"
    if path not in ("cluster", "two-pass") or (path == "cluster" and not fits):
        raise ValueError(f"groupnorm kernels: no {path} path for ({n}, {s}, {c})")
    if fits:
        rows = cl_rows
    else:
        want = max(1, -(-_BLOCKS_PER_SM * sms // n))
        least = max(_UNROLL * ty, _MIN_ROWS_QUANT if quant else 1)
        rows = max(-(-s // min(want, 1024)), least)
    p = -(-s // rows)
    lanes = max(1, min(8, 1024 // groups))
    if groups > 1024:
        raise ValueError(f"groupnorm kernels: groups={groups} > 1024")
    if path == "cluster":
        return GNPlan(tx, ty, rows, p, lanes, 1, cl_smem, n if quant else 0, path, 1)
    smem = ((4 if quant else 2) * ty * c + ty) * 4
    if smem > MAX_SHARED:
        raise ValueError(f"groupnorm kernels: C={c} needs {smem} bytes of shared memory")
    scratch = 2 * n * p * groups + 2 * n * groups
    finals = 1
    if quant:
        # K2's finalize: about two blocks per SM, each at least 1024 of the
        # sample's chunk extremes
        finals = max(1, min(-(-2 * sms // n), -(-p * c // 1024)))
        scratch += 2 * n * p * c + n * p + n * finals + n  # extrema, maxima, candidates, flags
    return GNPlan(tx, ty, rows, p, lanes, finals, smem, scratch, path, 2)


def groupnorm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         groups: int = 32, eps: float = 1e-5,
                         apply_silu: bool = True) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU) over a channels-last (N, ..., C)
    tensor, line for line the JAX ``_reference``: f32 statistics through
    (n, c) channel reductions, a centred variance, output in x's dtype."""
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    red = tuple(range(1, x.dim() - 1))
    bshape = (n,) + (1,) * (x.dim() - 2) + (c,)
    xf = x.float()
    mean_c = xf.mean(dim=red)                                   # (n, c)
    gmean = mean_c.reshape(n, groups, cg).mean(dim=-1)
    gmean_c = gmean.repeat_interleave(cg, dim=-1)               # (n, c)
    centered = xf - gmean_c.reshape(bshape)
    var_c = centered.square().mean(dim=red)                     # (n, c)
    gvar = var_c.reshape(n, groups, cg).mean(dim=-1)
    inv_c = torch.rsqrt(gvar + eps).repeat_interleave(cg, dim=-1)
    y = centered * inv_c.reshape(bshape)
    y = y * gamma.float() + beta.float()
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


_fn = None


def _k1_entry():
    global _fn
    if _fn is None:
        from free_hunch_tpu_torch.ops import _nvcc
        fn = _nvcc.load("groupnorm").fh_groupnorm_forward
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def groupnorm_silu_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        groups: int = 32, eps: float = 1e-5,
                        apply_silu: bool = True) -> torch.Tensor:
    """Launch the kernel on a contiguous channels-last (N, ..., C) CUDA
    tensor. Raises on anything the kernel does not take."""
    return _groupnorm_launch(x, gamma, beta, groups, eps, apply_silu)


def _groupnorm_launch(x, gamma, beta, groups, eps, apply_silu, path=None):
    """K1 as ``groupnorm_silu_cuda`` launches it; ``path`` forces a path
    (see ``gn_plan``), to compare the two."""
    global launches
    if not x.is_cuda:
        raise ValueError("groupnorm_silu_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"groupnorm kernel takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm kernel needs a contiguous channels-last tensor")
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // max(n * c, 1)
    if c % groups or s * (c // groups) >= 2 ** 24:
        raise ValueError(f"groupnorm kernel: C={c} must be a multiple of groups={groups}, "
                         f"and S*C/G={s * (c // groups)} < 2^24")
    if x.data_ptr() % 16:
        raise ValueError("groupnorm kernel needs a 16-byte aligned input")
    for t in (gamma, beta):
        if t.device != x.device or t.dtype != torch.float32 or \
                t.shape != (c,) or not t.is_contiguous():
            raise ValueError("gamma/beta must be contiguous f32 (C,) on x's device")
    plan = gn_plan(n, s, c, groups, x.element_size(), device_sms(x.device), path=path)
    y = torch.empty_like(x)
    scratch = torch.empty(plan.scratch, device=x.device, dtype=torch.float32) \
        if plan.scratch else None
    err = _k1_entry()(x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), n, s, c, groups,
                      plan.rows, plan.chunks, plan.ty, plan.lanes, float(eps),
                      int(apply_silu), int(plan.path == "cluster"),
                      int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm kernel launch failed: CUDA error {err}")
    launches += 1
    return y


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version
    (the JAX ``custom_vjp`` ``_bwd``, pallas_groupnorm.py:156-160)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, apply_silu):
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (groups, eps, apply_silu)
        return groupnorm_silu_cuda(x, gamma, beta, groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        # the profiler range lets a trace attribute the backward's device time
        with torch.profiler.record_function("groupnorm_silu_backward"), \
                torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip((x, gamma, beta), need)]
            y = groupnorm_silu_plain(*ins, *ctx.cfg)
            wanted = [t for t, r in zip(ins, need) if r]
            got = iter(torch.autograd.grad(y, wanted, g)) if wanted else iter(())
        return tuple(next(got) if r else None for r in need) + (None, None, None)


def groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int = 32, eps: float = 1e-5,
                   apply_silu: bool = True) -> torch.Tensor:
    """Fused GroupNorm(groups)(+SiLU) over a channels-last (N, ..., C) tensor.
    A CUDA tensor goes through the kernel (or this raises); a CPU tensor
    through the plain version."""
    if x.is_cuda:
        return _GroupNormSiLU.apply(x.contiguous(), gamma, beta, groups, eps,
                                    apply_silu)
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, gamma, beta, groups, eps, apply_silu)
    raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
