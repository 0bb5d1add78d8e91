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

The gradient with respect to x is a hand-written kernel too
(``csrc/gn_backward.cuh``, entry ``fh_groupnorm_backward``), which replaces
no TPU kernel: the JAX package's ``custom_vjp`` (:147-163) differentiates
the plain version, as this port did under autograd (about 40 f32 ATen
launches a norm). Its plain twin is ``groupnorm_silu_backward_plain``, its
planner ``gn_bwd_plan``: calls of more than 8 x 128 rows a sample (the
64-256 px calls) take two launches (sums, then dx) with the (mean, rstd)
that the forward's two-pass path computed, kept for it; the others (and
any call whose forward took K1's one-launch path, which keeps no
statistics) one launch, a thread-block cluster a sample. Where the gradient of gamma or beta is asked for, or on the
CPU, the backward stays autograd of the plain version.

On a height shard (``UNetModel(model_group=)``: each rank of a model
group holds some rows of every sample, maybe none) ``groupnorm_silu_sharded``
runs the two halves of the two-pass path with a merge across ranks between
them: the stats entry (``fh_groupnorm_stats``: this shard's (mean, M2,
count) per (sample, group); nothing is launched for a shard of no rows,
whose partial is (0, 0, 0)), one gather of those partials over the group,
and the apply entry (``fh_groupnorm_apply``), each of whose blocks first
merges the gathered partials in rank order in f32, each weighted by its
own count (Chan's merge, as the finalize merges chunks), so the shards may
be of any sizes. Its plain twin, ``groupnorm_silu_sharded_plain``, sums x
and the count and then the centred squares over the group (two
all_reduces); it runs on the CPU and in the backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from free_hunch_tpu_torch.utils import profiling

# Calls that launched the CUDA kernel sequence (stats, finalize, apply; or
# the one cluster kernel). Plain-version calls on CPU tensors do not count.
launches = 0
# Calls that launched the backward kernel (``groupnorm_silu_backward_cuda``).
bwd_launches = 0
# The height-sharded calls' launches of the stats entry (stats, finalize)
# and of the apply entry (``groupnorm_silu_sharded``): one of each a call.
sharded_launches = {"stats": 0, "apply": 0}

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


# The backward (csrc/gn_backward.cuh): blocks of at most 512 threads; the
# one-launch cluster path where a sample's chunk of ceil(s / 8) rows is at
# most 128 rows (the 8-32 px calls, re-read from L2) or the statistics are
# not carried.
_BWD_THREADS = 512
_BWD_CLUSTER_ROWS = 128
_BWD_UNROLL = 2


@functools.lru_cache(maxsize=4096)
def gn_bwd_plan(n: int, s: int, c: int, groups: int, itemsize: int, sms: int,
                carried: bool, path: Optional[str] = None) -> GNPlan:
    """The backward kernel's plan for n samples of s rows of c channels of
    ``itemsize`` bytes on a device with ``sms`` SMs; ``carried``: whether
    the forward's (mean, rstd) come with the call (K1's two-pass path keeps
    them, its one-launch path does not).

    The "two-pass" path where they are carried and a sample's chunk of
    ceil(s / 8) rows is more than 128 rows (the 64-256 px calls): blocks of
    about 256 threads, enough chunks per sample for about four blocks per SM
    (at most 1024), each at least one unrolled step of every thread row;
    sums, then dx. Otherwise the "cluster" path: one cluster of up to 8
    blocks a sample, one launch, up to 512 threads a block, which computes
    the statistics where they are not carried. ``reads`` counts the reads
    of x, ``scratch`` the f32 elements of scratch (the chunk sums). ``path``
    forces a path. Raises where the kernel cannot take the shape."""
    vec = 16 // itemsize
    if c % vec or c % groups:
        raise ValueError(f"groupnorm backward: C={c} must be a multiple of groups={groups} "
                         f"and of {vec}")
    tx = c // vec
    if tx > _BWD_THREADS:
        raise ValueError(f"groupnorm backward: C/{vec} = {tx} > {_BWD_THREADS}")
    cl_rows = -(-s // CLUSTER_BLOCKS)
    if path is None:
        path = "two-pass" if carried and cl_rows > _BWD_CLUSTER_ROWS else "cluster"
    if path not in ("cluster", "two-pass") or (path == "two-pass" and not carried):
        raise ValueError(f"groupnorm backward: no {path} path for ({n}, {s}, {c})"
                         f"{'' if carried else ' without the statistics'}")
    if path == "cluster":
        rows, ty, scratch = cl_rows, max(1, min(_BWD_THREADS // tx, cl_rows)), 0
    else:
        ty = max(1, _BLOCK_THREADS // tx)
        want = max(1, -(-_BLOCKS_PER_SM * sms // n))
        rows = max(-(-s // min(want, 1024)), _BWD_UNROLL * ty)
        scratch = 2 * n * -(-s // rows) * groups
    # the two-pass merge takes a thread a group; the cluster path loops
    if groups > (tx * ty if path == "two-pass" else _BWD_THREADS):
        raise ValueError(f"groupnorm backward: groups={groups} > the block's {tx * ty} threads")
    smem = (2 * ty * c + ty) * 4
    if smem > MAX_SHARED - 12 * 1024:
        raise ValueError(f"groupnorm backward: C={c} needs {smem} bytes of shared memory")
    return GNPlan(tx, ty, rows, -(-s // rows), 1, 1, smem, scratch, path, 2 if carried else 3)


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


def groupnorm_silu_backward_plain(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                                  beta: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                                  apply_silu: bool = True) -> torch.Tensor:
    """The input gradient of ``groupnorm_silu_plain`` at x for the
    cotangent dy, in closed form: the backward kernel's arithmetic line for
    line, in f32, rounded once to x's type. Per (sample, group), with
    x^ = (x - mean) * rstd, z = gamma x^ + beta and dy^ = dy * SiLU'(z) *
    gamma: dx = rstd * (dy^ - mean(dy^) - x^ * mean(dy^ x^))."""
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xf = x.float().reshape(n, -1, groups, cg)
    red = (1, 3)
    mean = xf.mean(dim=red, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=red, keepdim=True) + eps)
    gm, bt = gamma.float().reshape(groups, cg), beta.float().reshape(groups, cg)
    xh = (xf - mean) * rstd
    d = dy.float().reshape(xf.shape)
    if apply_silu:
        z = xh * gm + bt
        sig = 1 / (1 + torch.exp(-z))
        d = d * (sig * (1 + z * (1 - sig)))
    dyh = d * gm
    ca = dyh.mean(dim=red, keepdim=True)
    cb = (dyh * xh).mean(dim=red, keepdim=True)
    return (rstd * (dyh - ca - xh * cb)).reshape(x.shape).to(x.dtype)


_fn = None
_bwd_fn = None


def _k1_entry():
    global _fn
    if _fn is None:
        from free_hunch_tpu_torch.ops import _nvcc
        fn = _nvcc.load("groupnorm").fh_groupnorm_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _k1_backward_entry():
    global _bwd_fn
    if _bwd_fn is None:
        from free_hunch_tpu_torch.ops import _nvcc
        fn = _nvcc.load("groupnorm").fh_groupnorm_backward
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def groupnorm_silu_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        groups: int = 32, eps: float = 1e-5,
                        apply_silu: bool = True) -> torch.Tensor:
    """Launch the kernel on a contiguous channels-last (N, ..., C) CUDA
    tensor. Raises on anything the kernel does not take."""
    return _groupnorm_launch(x, gamma, beta, groups, eps, apply_silu)


def _check_k1_input(x, groups, gamma=None, beta=None):
    """(N, S, C) of a K1 input, raising on anything the kernel does not take."""
    if not x.is_cuda:
        raise ValueError("groupnorm kernel needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"groupnorm kernel takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("groupnorm kernel needs a contiguous, 16-byte aligned channels-last "
                         "tensor")
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // max(n * c, 1)
    if c % groups or s * (c // groups) >= 2 ** 24:
        raise ValueError(f"groupnorm kernel: C={c} must be a multiple of groups={groups}, "
                         f"and S*C/G={s * (c // groups)} < 2^24")
    for t in (gamma, beta):
        if t is not None and (t.device != x.device or t.dtype != torch.float32 or
                              t.shape != (c,) or not t.is_contiguous()):
            raise ValueError("gamma/beta must be contiguous f32 (C,) on x's device")
    return n, s, c


def _groupnorm_launch(x, gamma, beta, groups, eps, apply_silu, path=None, keep_stats=False):
    """K1 as ``groupnorm_silu_cuda`` launches it; ``path`` forces a path
    (see ``gn_plan``), to compare the two. With ``keep_stats``, returns (y,
    stats): the (N, G, 2) f32 (mean, rstd) the two-pass path computed, in a
    tensor of their own (the same launches and bytes), or None on the
    cluster path, which keeps them on chip."""
    global launches
    n, s, c = _check_k1_input(x, groups, gamma, beta)
    plan = gn_plan(n, s, c, groups, x.element_size(), device_sms(x.device), path=path)
    y = torch.empty_like(x)
    scratch = stats = None
    if plan.scratch:
        tail = 2 * n * groups if keep_stats else 0
        scratch = torch.empty(plan.scratch - tail, device=x.device, dtype=torch.float32)
        if keep_stats:
            stats = torch.empty((n, groups, 2), device=x.device, dtype=torch.float32)
    err = _k1_entry()(x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      None if stats is None else stats.data_ptr(), n, s, c, groups,
                      plan.rows, plan.chunks, plan.ty, plan.lanes, float(eps),
                      int(apply_silu), int(plan.path == "cluster"),
                      int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm kernel launch failed: CUDA error {err}")
    launches += 1
    return (y, stats) if keep_stats else y


def groupnorm_silu_backward_cuda(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                                 apply_silu: bool = True, stats: Optional[torch.Tensor] = None,
                                 path: Optional[str] = None) -> torch.Tensor:
    """The backward kernel: dx (x's type) of ``groupnorm_silu`` at a
    contiguous channels-last CUDA x for the cotangent dy (x's shape and
    type). ``stats``: the forward's (N, G, 2) f32 (mean, rstd), or None to
    compute them; ``path`` forces a path (see ``gn_bwd_plan``). Raises on
    anything the kernel does not take."""
    global bwd_launches
    n, s, c = _check_k1_input(x, groups, gamma, beta)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or \
            dy.data_ptr() % 16:
        raise ValueError("groupnorm backward: dy must be a 16-byte aligned tensor of x's "
                         "shape, type and device")
    if stats is not None and (stats.shape != (n, groups, 2) or stats.dtype != torch.float32 or
                              stats.device != x.device or not stats.is_contiguous()):
        raise ValueError("groupnorm backward: stats must be contiguous f32 (N, G, 2) on x's "
                         "device")
    plan = gn_bwd_plan(n, s, c, groups, x.element_size(), device_sms(x.device),
                       stats is not None, path)
    dx = torch.empty_like(x)
    scratch = torch.empty(plan.scratch, device=x.device, dtype=torch.float32) \
        if plan.scratch else None
    entry = _k1_backward_entry()
    # an operator record, so that the backward's span takes the kernels' time
    with profiling.launch("fh_groupnorm_backward"):
        err = entry(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), gamma.data_ptr(),
                    beta.data_ptr(), None if stats is None else stats.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), n, s, c, groups, plan.rows,
                    plan.chunks, plan.ty, float(eps), int(apply_silu),
                    int(plan.path == "cluster"), int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm backward launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx


def backward_route(is_cuda: bool, need) -> str:
    """Which backward a call of ``_GroupNormSiLU`` takes: "kernel" where x
    lies on a card and only its gradient is asked for, else "plain"
    (autograd of the plain version: the CPU, or dgamma / dbeta asked for,
    which the kernel does not compute)."""
    return "kernel" if is_cuda and tuple(need) == (True, False, False) else "plain"


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: the kernel, keeping the statistics its two-pass path
    computed. Backward: the backward kernel, or autograd of the plain
    version (the JAX ``custom_vjp`` ``_bwd``, pallas_groupnorm.py:156-160)
    where ``backward_route`` says so."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, apply_silu):
        if x.is_cuda:
            y, stats = _groupnorm_launch(x, gamma, beta, groups, eps, apply_silu,
                                         keep_stats=True)
        else:  # groupnorm_silu_cuda raises on it
            y, stats = groupnorm_silu_cuda(x, gamma, beta, groups, eps, apply_silu), None
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.cfg = (groups, eps, apply_silu)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, stats = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        # the profiler range lets a trace attribute the backward's device time
        with profiling.span("groupnorm_silu_backward"):
            if backward_route(x.is_cuda, need) == "kernel":
                profiling.count("gn_bwd.kernel")
                dx = groupnorm_silu_backward_cuda(x, g, gamma, beta, *ctx.cfg, stats=stats)
                return dx, None, None, None, None, None
            profiling.count("gn_bwd.plain")
            with torch.enable_grad():
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


# -- a height shard: statistics merged across the ranks of a model group ------

def sharded_normalize_plain(x: torch.Tensor, groups: int, eps: float, mg) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) in f32 for a channels-last (N, ..., C)
    shard whose samples continue on the other ranks of the model group
    ``mg``, with the whole samples' group statistics: two passes, centred,
    each a differentiable all_reduce of per-(sample, group) sums (the first
    carries each shard's element count, so shards may differ in size or be
    empty). The plain twin of K1's and K2's shard entries, and what their
    backward differentiates."""
    from free_hunch_tpu_torch.parallel import collectives as coll
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    red = tuple(range(1, x.dim() - 1))
    bshape = (n,) + (1,) * (x.dim() - 2) + (c,)
    xf = x.float()
    count = float(x[:1].numel() // c * cg)
    gsum = xf.sum(dim=red).reshape(n, groups, cg).sum(-1)
    merged = coll.all_reduce(torch.cat([gsum, gsum.new_full((n, 1), count)], dim=1), mg)
    total = merged[:, groups:]
    gmean_c = (merged[:, :groups] / total).repeat_interleave(cg, dim=-1)
    centered = xf - gmean_c.reshape(bshape)
    gsq = coll.all_reduce(centered.square().sum(dim=red).reshape(n, groups, cg).sum(-1), mg)
    inv_c = torch.rsqrt(gsq / total + eps).repeat_interleave(cg, dim=-1)
    return centered * inv_c.reshape(bshape)


def groupnorm_silu_sharded_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                 groups: int, eps: float, apply_silu: bool,
                                 mg) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU) of a channels-last (N, ..., C) shard
    whose samples continue on the other ranks of the model group ``mg``
    (shards of any sizes): ``sharded_normalize_plain``, then the (C,)
    affine and the SiLU; autograd through it is the gradient of the whole
    norm."""
    y = sharded_normalize_plain(x, groups, eps, mg)
    y = y * gamma.float() + beta.float()
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


_sharded_fns: dict = {}


def _k1_sharded_entries():
    if not _sharded_fns:
        from free_hunch_tpu_torch.ops import _nvcc
        lib = _nvcc.load("groupnorm")
        st, ap = lib.fh_groupnorm_stats, lib.fh_groupnorm_apply
        st.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        ap.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 +
                       [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 2 +
                       [ctypes.c_void_p])
        st.restype = ap.restype = ctypes.c_int
        _sharded_fns.update(stats=st, apply=ap)
    return _sharded_fns


def shard_stats_cuda(x: torch.Tensor, groups: int = 32) -> torch.Tensor:
    """The stats entry on a contiguous channels-last CUDA shard: (N, G, 3)
    f32, this shard's (mean, M2, count) per (sample, group). A shard of no
    rows launches nothing and gives (0, 0, 0)."""
    n, s, c = _check_k1_input(x, groups)
    out = torch.zeros((n, groups, 3), device=x.device, dtype=torch.float32)
    if s == 0:
        return out
    plan = gn_plan(n, s, c, groups, x.element_size(), device_sms(x.device), path="two-pass")
    scratch = torch.empty(2 * n * plan.chunks * groups, device=x.device, dtype=torch.float32)
    err = _k1_sharded_entries()["stats"](
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, s, c, groups, plan.rows,
        plan.chunks, plan.ty, plan.lanes, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm stats launch failed: CUDA error {err}")
    sharded_launches["stats"] += 1
    return out


def shard_apply_cuda(x: torch.Tensor, parts: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                     apply_silu: bool = True) -> torch.Tensor:
    """The apply entry: y from x and the model group's gathered statistics,
    ``parts`` (M, N, G, 3) f32, each rank's (mean, M2, count), which the
    kernel merges in rank order, weighted by the counts (Chan's merge, as
    the finalize merges chunks) before it applies them. A shard of no rows
    launches nothing."""
    n, s, c = _check_k1_input(x, groups, gamma, beta)
    if parts.dim() != 4 or parts.shape[1:] != (n, groups, 3) or \
            parts.dtype != torch.float32 or not parts.is_contiguous() or \
            parts.device != x.device:
        raise ValueError("parts must be contiguous f32 (M, N, G, 3) on x's device")
    y = torch.empty_like(x)
    if s == 0:
        return y
    plan = gn_plan(n, s, c, groups, x.element_size(), device_sms(x.device), path="two-pass")
    err = _k1_sharded_entries()["apply"](
        x.data_ptr(), y.data_ptr(), parts.data_ptr(), parts.shape[0], gamma.data_ptr(),
        beta.data_ptr(), n, s, c, groups, plan.rows, plan.chunks, plan.ty, eps,
        int(apply_silu), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm apply launch failed: CUDA error {err}")
    sharded_launches["apply"] += 1
    return y


def groupnorm_silu_sharded_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                groups: int, eps: float, apply_silu: bool,
                                mg) -> torch.Tensor:
    """The kernel path of a height shard: the stats entry, one gather of
    the (N, G, 3) partials over the model group ``mg``, the apply entry
    (which merges them). Raises on anything the kernels do not take."""
    from free_hunch_tpu_torch.parallel import collectives as coll
    part = shard_stats_cuda(x, groups)
    with torch.no_grad():
        parts = coll.gather_replicated(part[None], 0, mg).contiguous()
    return shard_apply_cuda(x, parts, gamma, beta, groups, eps, apply_silu)


class _GroupNormSiLUSharded(torch.autograd.Function):
    """Forward: the sharded kernel path. Backward: autograd of the plain
    sharded version, whose all_reduces carry their gradients."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, apply_silu, mg):
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (groups, eps, apply_silu, mg)
        return groupnorm_silu_sharded_cuda(x, gamma, beta, groups, eps, apply_silu, mg)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with profiling.span("groupnorm_silu_backward"), \
                torch.enable_grad():
            ins = [t.detach().requires_grad_(r) for t, r in zip((x, gamma, beta), need)]
            y = groupnorm_silu_sharded_plain(*ins, *ctx.cfg)
            wanted = [t for t, r in zip(ins, need) if r]
            got = iter(torch.autograd.grad(y, wanted, g)) if wanted else iter(())
        return tuple(next(got) if r else None for r in need) + (None,) * 4


def groupnorm_silu_sharded(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           groups: int, eps: float, apply_silu: bool, mg) -> torch.Tensor:
    """GroupNorm(groups)(+SiLU) of a channels-last height shard, with the
    statistics of the whole samples over the model group ``mg``. A CUDA
    tensor goes through the kernel entries (or this raises); a CPU tensor
    through the plain sharded version."""
    if x.is_cuda:
        return _GroupNormSiLUSharded.apply(x.contiguous(), gamma, beta, groups, eps,
                                           apply_silu, mg)
    if x.device.type == "cpu":
        return groupnorm_silu_sharded_plain(x, gamma, beta, groups, eps, apply_silu, mg)
    raise ValueError(f"groupnorm_silu_sharded: unsupported device {x.device}")
