"""GroupNorm + per-sample affine + SiLU + per-sample int8 quantise over
channels-last activations: the hand-written Hopper kernel
``csrc/gn_quant.cu`` (K2) and its plain PyTorch version.

Counterpart of ``free_hunch_tpu/ops/pallas_gn_quant.py``: the TPU kernel's
three passes ``_stats_kernel`` (:71-95), ``_amax_kernel`` (:116-128) and
``_quant_kernel`` (:131-137), launched by ``_pallas_gn_silu_quant``
(:140-189) behind ``gn_silu_quant`` (:192). It computes that file's twin
``gn_silu_quant_reference`` (:50-68):

    y  = silu((x - mean_g) * rsqrt(var_g + eps) * gamma[n, c] + beta[n, c])
    xq = clip(round(y / s_n), -127, 127) int8,   s_n = max(max|y_n|, 1e-12) / 127

and returns ``(xq (n, h, w, c) int8, scale (n, 1, 1, 1) f32)``. The kernel
takes the correctly rounded y / s_n as the twin does (the Pallas kernel
multiplies by 1/s_n), computes the statistics with a centred variance and
the SiLU with ``__expf`` and an approximate division; its y
can differ from the plain version's in the last bits, so a code can differ
by one where y / s_n lies within rounding of a half-integer.

Bound: device-memory bytes (about 20 instructions per element against 2
bytes read and 1 written). The kernel reads x at most twice: the
statistics pass also keeps the min and max of x per (chunk, channel), and
the per-sample abs-max is taken from them (``gn_silu_quant_scale_plain``
is that arithmetic in PyTorch); only a sample whose abs-max may lie inside
the SiLU's negative lobe is flagged for a full abs-max pass over its
elements. A call whose sample fits a thread-block cluster's shared memory
(``gn_plan``'s "cluster" path) reads x once, in one launch. See the
sources. ``ops/quant.py::gn_quant_conv`` is its caller.

On a height shard (``gn_silu_quant_sharded``: each rank of a model group
holds some rows of every sample, maybe none) the statistics, the extremes
and the scale are the whole sample's: the stats entry
(``fh_gn_silu_quant_shard_stats``: the shard's (mean, M2, count) per
(sample, group) and (min, max) of x per (sample, channel), in one read of
the shard), one gather of those partials over the group, the merge entry
(``fh_gn_silu_quant_shard_merge``: the ranks' group partials merged in rank
order, each channel's extremes over the ranks, from them the candidate
scale and the flag, and for a flagged sample the full abs-max pass over
the shard), a max-merge of the flagged samples' abs-max across the group
(only when a sample is flagged; the flags come from the gathered data, so
every rank takes the same branch), and the apply entry
(``fh_gn_silu_quant_shard_apply``: the quantise pass). The plain twin is
``gn_silu_quant_sharded_plain``. The one-launch cluster path is not used
on a shard.
"""
from __future__ import annotations

import ctypes

import torch

from free_hunch_tpu_torch.ops.groupnorm import device_sms, gn_plan, sharded_normalize_plain
from free_hunch_tpu_torch.parallel import collectives as coll

# Calls that launched the CUDA kernel sequence (stats, finalize, amax,
# quantise; or the one cluster kernel). Plain-version calls on CPU tensors
# do not count.
launches = 0
# The height-sharded calls' launches of the stats, merge and apply entries
# (``gn_silu_quant_sharded``): one of each a call (none of the stats entry
# for a shard of no rows).
sharded_launches = {"stats": 0, "merge": 0, "apply": 0}

# max |SiLU(t)| over t < 0 is 0.278465 (at t = -1.2785); a candidate
# abs-max from the channels' extremes at or above this is exact
LOBE = 0.2785

def _gn_silu_ref_f32(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                     groups: int, eps: float) -> torch.Tensor:
    """Unquantised GroupNorm + per-sample affine + SiLU in f32, line for
    line the JAX package's ``_gn_silu_ref_f32`` (``ops/quant.py:348-363``),
    which is also the first half of ``gn_silu_quant_reference``; the
    differentiation formulation of ``gn_quant_conv``'s backward."""
    n, h, w, c = x.shape
    cg = c // groups
    xf = x.float()
    mean_c = xf.mean(dim=(1, 2))
    gmean = mean_c.reshape(n, groups, cg).mean(dim=-1)
    gmean_c = gmean.repeat_interleave(cg, dim=-1)
    centered = xf - gmean_c[:, None, None, :]
    var_c = centered.square().mean(dim=(1, 2))
    gvar = var_c.reshape(n, groups, cg).mean(dim=-1)
    inv_c = torch.rsqrt(gvar + eps).repeat_interleave(cg, dim=-1)
    y = centered * inv_c[:, None, None, :]
    y = y * gamma_nc[:, None, None, :] + beta_nc[:, None, None, :]
    return y * torch.sigmoid(y)


def gn_silu_quant_plain(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                        groups: int = 32, eps: float = 1e-5):
    """Line for line ``gn_silu_quant_reference``: x (n, h, w, c) bf16 or
    f32, gamma_nc and beta_nc (n, c) f32. Returns (xq int8, scale
    (n, 1, 1, 1) f32)."""
    y = _gn_silu_ref_f32(x, gamma_nc, beta_nc, groups, eps)
    amax = y.abs().amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    xq = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return xq, scale


def gn_silu_quant_scale_plain(lo: torch.Tensor, hi: torch.Tensor, mean: torch.Tensor,
                              rstd: torch.Tensor, gamma_nc: torch.Tensor,
                              beta_nc: torch.Tensor):
    """The arithmetic of K2's finalize in PyTorch: from the min ``lo`` and
    max ``hi`` of x per (sample, chunk, channel), (n, p, c), and the group
    statistics ``mean`` and ``rstd`` (n, groups), the candidate scale per
    sample and the flag of the samples whose abs-max needs the full pass.

    Within a channel t = (x - mean) * rstd * gamma + beta is monotone in x,
    so the channel's extreme t lie at its extreme x; |SiLU(t)| grows with t
    for t >= 0 and stays below ``LOBE`` for t < 0. So the largest
    |SiLU(t)| at the extremes is the sample's abs-max whenever it reaches
    ``LOBE``; below it the sample is flagged. Returns (scale (n, 1, 1, 1)
    f32, flag (n,) bool)."""
    n, _, c = lo.shape
    rep = c // mean.shape[1]
    mu = mean.repeat_interleave(rep, dim=1)[:, None, :]
    rs = rstd.repeat_interleave(rep, dim=1)[:, None, :]

    def abs_y(v):
        t = (v - mu) * rs * gamma_nc[:, None, :] + beta_nc[:, None, :]
        return (t * torch.sigmoid(t)).abs()

    amax = torch.maximum(abs_y(lo), abs_y(hi)).reshape(n, -1).amax(dim=1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return scale.reshape(n, 1, 1, 1), ~(amax >= LOBE)


def gn_silu_quant_cuda(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                       groups: int = 32, eps: float = 1e-5):
    """Launch K2 on a contiguous channels-last (n, h, w, c) CUDA tensor.
    Raises on anything the kernel does not take."""
    xq, scale, _ = _k2_launch(x, gamma_nc, beta_nc, groups, eps)
    return xq, scale


_fn = None


def _k2_entry():
    global _fn
    if _fn is None:
        from free_hunch_tpu_torch.ops import _nvcc
        fn = _nvcc.load("gn_quant").fh_gn_silu_quant_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _gn_silu_quant_launch(x, gamma_nc, beta_nc, groups=32, eps=1e-5, full=False,
                          path=None):
    """K2 as ``gn_silu_quant_cuda`` launches it, returning also the flag of
    each sample whose abs-max lies below ``LOBE`` (on the two-pass path:
    the samples that took the full abs-max pass), (n,) int32. ``full``
    flags every sample, so the two-pass path's scale comes from the full
    pass (to compare with the scale from the extremes); ``path`` forces a
    path (see ``gn_plan``)."""
    xq, scale, scratch = _k2_launch(x, gamma_nc, beta_nc, groups, eps, full, path)
    n = x.shape[0]
    return xq, scale, scratch[scratch.numel() - n:].view(torch.int32)


def _k2_launch(x, gamma_nc, beta_nc, groups=32, eps=1e-5, full=False, path=None):
    """Check, plan and launch K2; returns (xq, scale, scratch)."""
    global launches
    n, s, c = _check_k2_input(x, groups, gamma_nc, beta_nc)
    plan = gn_plan(n, s, c, groups, x.element_size(), device_sms(x.device), quant=True,
                   path=path)
    dev = x.device
    xq = torch.empty(x.shape, device=dev, dtype=torch.int8)
    scale = torch.empty((n, 1, 1, 1), device=dev, dtype=torch.float32)
    scratch = torch.empty(plan.scratch, device=dev, dtype=torch.float32)
    err = _k2_entry()(x.data_ptr(), gamma_nc.data_ptr(), beta_nc.data_ptr(),
                      scratch.data_ptr(), xq.data_ptr(), scale.data_ptr(), n, s, c, groups,
                      plan.rows, plan.chunks, plan.ty, plan.lanes, plan.finals, float(eps),
                      int(x.dtype == torch.bfloat16), int(full), int(plan.path == "cluster"),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_quant kernel launch failed: CUDA error {err}")
    launches += 1
    return xq, scale, scratch


def gn_silu_quant(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                  groups: int = 32, eps: float = 1e-5):
    """GroupNorm + per-sample affine + SiLU + per-sample int8 quantise of a
    (n, h, w, c) tensor. A CUDA tensor goes through the kernel (or this
    raises); a CPU tensor through the plain version."""
    if x.is_cuda:
        return gn_silu_quant_cuda(x.contiguous(), gamma_nc.contiguous(),
                                  beta_nc.contiguous(), groups, eps)
    if x.device.type == "cpu":
        return gn_silu_quant_plain(x, gamma_nc, beta_nc, groups, eps)
    raise ValueError(f"gn_silu_quant: unsupported device {x.device}")


# -- a height shard: statistics, extremes and scale merged across ranks -------

def gn_silu_sharded_ref_f32(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                            groups: int, eps: float, mg) -> torch.Tensor:
    """``_gn_silu_ref_f32`` of a (n, h, w, c) height shard over the model
    group ``mg``: the whole samples' group statistics
    (``ops/groupnorm.py::sharded_normalize_plain``), the per-sample affine
    and the SiLU in f32. What the sharded fused route's backward
    differentiates."""
    y = sharded_normalize_plain(x, groups, eps, mg)
    y = y * gamma_nc[:, None, None, :] + beta_nc[:, None, None, :]
    return y * torch.sigmoid(y)


def gn_silu_quant_sharded_plain(x: torch.Tensor, gamma_nc: torch.Tensor,
                                beta_nc: torch.Tensor, groups: int, eps: float, mg):
    """``gn_silu_quant_plain`` of a (n, h, w, c) height shard over the model
    group ``mg``: y from the whole samples' statistics, the per-sample
    abs-max max-merged over the group, this rank's codes. Returns (xq
    int8, scale (n, 1, 1, 1) f32)."""
    from free_hunch_tpu_torch.ops.quant import _abs_max
    y = gn_silu_sharded_ref_f32(x, gamma_nc, beta_nc, groups, eps, mg)
    amax = coll.all_max(_abs_max(y), mg)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    xq = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return xq, scale


_shard_fns: dict = {}


def _k2_shard_entries():
    if not _shard_fns:
        from free_hunch_tpu_torch.ops import _nvcc
        lib = _nvcc.load("gn_quant")
        st = lib.fh_gn_silu_quant_shard_stats
        st.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        mg = lib.fh_gn_silu_quant_shard_merge
        mg.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        ap = lib.fh_gn_silu_quant_shard_apply
        ap.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        st.restype = mg.restype = ap.restype = ctypes.c_int
        _shard_fns.update(stats=st, merge=mg, apply=ap)
    return _shard_fns


def _check_k2_input(x, groups, gamma_nc=None, beta_nc=None):
    """(n, s, c) of a K2 input, raising on anything the kernel does not take."""
    if not x.is_cuda:
        raise ValueError("gn_silu_quant kernel needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gn_silu_quant kernel takes bf16 or f32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("gn_silu_quant kernel needs a contiguous (n, h, w, c) tensor")
    n, h, w, c = x.shape
    s = h * w
    # 32 | C gives whole vectors of codes in every pass
    if c % groups or c % 32 or s * (c // groups) >= 2 ** 24:
        raise ValueError(f"gn_silu_quant kernel: C={c} must be a multiple of "
                         f"groups={groups} and of 32, and S*C/G={s * (c // groups)} < 2^24")
    if x.data_ptr() % 16:
        raise ValueError("gn_silu_quant kernel needs a 16-byte aligned input")
    for t in (gamma_nc, beta_nc):
        if t is not None and (t.device != x.device or t.dtype != torch.float32 or
                              t.shape != (n, c) or not t.is_contiguous()):
            raise ValueError("gamma_nc/beta_nc must be contiguous f32 (n, c) on x's device")
    return n, s, c


def _shard_plan(n, s, c, groups, x):
    """The two-pass cut of a shard; a shard of no rows takes one empty
    chunk (the merge and apply entries still run for it: the flags and
    the max-merge are the group's)."""
    plan = gn_plan(n, max(s, 1), c, groups, x.element_size(), device_sms(x.device),
                   quant=True, path="two-pass")
    return plan if s else plan._replace(chunks=1)


def shard_quant_stats_cuda(x: torch.Tensor, groups: int = 32) -> torch.Tensor:
    """K2's stats entry on a contiguous (n, h, w, c) CUDA shard: (n, 3G +
    2C) f32, per sample the shard's (mean, M2, count) of each group, then
    (min, max) of x in each channel. A shard of no rows launches nothing
    and gives (0, 0, 0) and (+inf, -inf)."""
    n, s, c = _check_k2_input(x, groups)
    out = torch.zeros((n, 3 * groups + 2 * c), device=x.device, dtype=torch.float32)
    if s == 0:
        out[:, 3 * groups:].view(n, c, 2).copy_(
            torch.tensor([float("inf"), float("-inf")], device=x.device))
        return out
    plan = _shard_plan(n, s, c, groups, x)
    scratch = torch.empty(2 * n * plan.chunks * (groups + c), device=x.device,
                          dtype=torch.float32)
    err = _k2_shard_entries()["stats"](
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, s, c, groups, plan.rows,
        plan.chunks, plan.ty, plan.lanes, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_quant stats launch failed: CUDA error {err}")
    sharded_launches["stats"] += 1
    return out


def shard_quant_merge_cuda(x: torch.Tensor, parts: torch.Tensor, gamma_nc: torch.Tensor,
                           beta_nc: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                           full: bool = False):
    """K2's merge entry: from the group's gathered partials ``parts`` (M,
    n, 3G + 2C), the merged (mean, rstd), each sample's candidate scale and
    flag, and for a flagged sample (every sample with ``full``) the abs-max
    of its y over this shard. Returns (work, flags (n,) int32, amax (n,)
    f32: this shard's abs-max of a flagged sample, else 0); ``work`` is
    what the apply entry reads."""
    n, s, c = _check_k2_input(x, groups, gamma_nc, beta_nc)
    if parts.dim() != 3 or parts.shape[1:] != (n, 3 * groups + 2 * c) or \
            parts.dtype != torch.float32 or not parts.is_contiguous() or \
            parts.device != x.device:
        raise ValueError("parts must be contiguous f32 (M, n, 3G + 2C) on x's device")
    plan = _shard_plan(n, s, c, groups, x)
    p = plan.chunks
    # stats (n * G float2), candidates (n), partial maxima (n * P), the
    # shard's abs-max (n), flags (n int32)
    work = torch.empty(2 * n * groups + n + n * p + n + n, device=x.device,
                       dtype=torch.float32)
    err = _k2_shard_entries()["merge"](
        x.data_ptr(), parts.data_ptr(), parts.shape[0], gamma_nc.data_ptr(),
        beta_nc.data_ptr(), work.data_ptr(), n, s, c, groups, plan.rows, p, plan.ty, eps,
        int(full), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_quant merge launch failed: CUDA error {err}")
    sharded_launches["merge"] += 1
    flags = work[work.numel() - n:].view(torch.int32)
    amax = work[work.numel() - 2 * n:work.numel() - n]
    return work, flags, amax


def shard_quant_apply_cuda(x: torch.Tensor, work: torch.Tensor, amax: torch.Tensor,
                           gamma_nc: torch.Tensor, beta_nc: torch.Tensor, groups: int = 32):
    """K2's apply entry: the codes of this shard at each sample's scale, the
    candidate of an unflagged sample, ``amax`` (the group's max-merged
    abs-max) of a flagged one. Returns (xq int8, scale (n, 1, 1, 1) f32)."""
    n, s, c = _check_k2_input(x, groups, gamma_nc, beta_nc)
    plan = _shard_plan(n, s, c, groups, x)
    xq = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    scale = torch.empty((n, 1, 1, 1), device=x.device, dtype=torch.float32)
    amax = amax.contiguous()
    err = _k2_shard_entries()["apply"](
        x.data_ptr(), gamma_nc.data_ptr(), beta_nc.data_ptr(), work.data_ptr(),
        amax.data_ptr(), xq.data_ptr(), scale.data_ptr(), n, s, c, groups, plan.rows,
        plan.chunks, plan.ty, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_quant apply launch failed: CUDA error {err}")
    sharded_launches["apply"] += 1
    return xq, scale


def gn_silu_quant_sharded_cuda(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                               groups: int, eps: float, mg, full: bool = False):
    """K2's kernel path of a height shard (module docstring): the stats
    entry, one gather of the partials over ``mg``, the merge entry, the
    max-merge of the flagged samples' abs-max, the apply entry. ``full``
    flags every sample. Raises on anything the kernels do not take."""
    gamma_nc, beta_nc = gamma_nc.contiguous(), beta_nc.contiguous()
    part = shard_quant_stats_cuda(x, groups)
    parts = coll.gather_replicated(part[None], 0, mg).contiguous()
    work, flags, amax = shard_quant_merge_cuda(x, parts, gamma_nc, beta_nc, groups, eps, full)
    # the flags come from the gathered partials: every rank reads the same
    if bool(flags.any()):
        amax = coll.all_max(amax, mg)
    return shard_quant_apply_cuda(x, work, amax, gamma_nc, beta_nc, groups)


def gn_silu_quant_sharded(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                          groups: int, eps: float, mg):
    """GroupNorm + per-sample affine + SiLU + per-sample int8 quantise of a
    (n, h, w, c) height shard over the model group ``mg``, with the whole
    samples' statistics and scale. A CUDA tensor goes through the kernel
    entries (or this raises); a CPU tensor through the plain twin."""
    if x.is_cuda:
        return gn_silu_quant_sharded_cuda(x.contiguous(), gamma_nc, beta_nc, groups, eps, mg)
    if x.device.type == "cpu":
        return gn_silu_quant_sharded_plain(x, gamma_nc, beta_nc, groups, eps, mg)
    raise ValueError(f"gn_silu_quant_sharded: unsupported device {x.device}")
