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
"""
from __future__ import annotations

import ctypes

import torch

from free_hunch_tpu_torch.ops.groupnorm import device_sms, gn_plan

# Calls that launched the CUDA kernel sequence (stats, finalize, amax,
# quantise; or the one cluster kernel). Plain-version calls on CPU tensors
# do not count.
launches = 0

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
    if not x.is_cuda:
        raise ValueError("gn_silu_quant_cuda needs a CUDA tensor")
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
        if t.device != x.device or t.dtype != torch.float32 or \
                t.shape != (n, c) or not t.is_contiguous():
            raise ValueError("gamma_nc/beta_nc must be contiguous f32 (n, c) on x's device")
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
