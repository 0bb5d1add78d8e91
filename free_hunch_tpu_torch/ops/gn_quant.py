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
divides by s_n as the twin does (the Pallas kernel multiplies by 1/s_n) and
computes the statistics with a centred variance; its y can differ from the
plain version's in the last bits, so a code can differ by one where
y / s_n lies within rounding of a half-integer.

Bound: device-memory bytes (about 15 flops per element against 2 bytes
read and 1 written); the kernel reads x three times (statistics, abs-max,
quantise), see the source. ``ops/quant.py::gn_quant_conv`` is its caller.
"""
from __future__ import annotations

import ctypes

import torch

from free_hunch_tpu_torch.ops.groupnorm import _MAX_SHARED, _plan

# Calls that launched the CUDA kernel sequence (stats, finalize, amax,
# quantise). Plain-version calls on CPU tensors do not count.
launches = 0


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


def gn_silu_quant_cuda(x: torch.Tensor, gamma_nc: torch.Tensor, beta_nc: torch.Tensor,
                       groups: int = 32, eps: float = 1e-5):
    """Launch K2 on a contiguous channels-last (n, h, w, c) CUDA tensor.
    Raises on anything the kernel does not take."""
    global launches
    from free_hunch_tpu_torch.ops import _nvcc

    if not x.is_cuda:
        raise ValueError("gn_silu_quant_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gn_silu_quant kernel takes bf16 or f32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("gn_silu_quant kernel needs a contiguous (n, h, w, c) tensor")
    n, h, w, c = x.shape
    s = h * w
    vec = 8 if x.dtype == torch.bfloat16 else 4
    # 32 | C gives whole 16-channel vectors in every pass (and 8 | C)
    if c % groups or c % 32 or c // vec > 1024:
        raise ValueError(f"gn_silu_quant kernel: C={c} must be a multiple of "
                         f"groups={groups} and of 32, and C/{vec} <= 1024")
    if groups * 8 > 1024 or s * (c // groups) >= 2 ** 24:
        raise ValueError(f"gn_silu_quant kernel: groups={groups}, S*C/G="
                         f"{s * (c // groups)} out of range")
    if x.data_ptr() % 16:
        raise ValueError("gn_silu_quant kernel needs a 16-byte aligned input")
    for t in (gamma_nc, beta_nc):
        if t.device != x.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (n, c) or not t.is_contiguous():
            raise ValueError("gamma_nc/beta_nc must be contiguous f32 (n, c) on x's device")
    ty1, rows1, p1 = _plan(n, s, c, vec)
    ty2, rows2, p2 = _plan(n, s, c, 16)
    if (2 * ty1 * c + ty1) * 4 > _MAX_SHARED:
        raise ValueError(f"gn_silu_quant kernel: C={c} needs too much shared memory")
    fn = _nvcc.load("gn_quant").fh_gn_silu_quant_forward
    if fn.argtypes is None:  # ctypes keeps one function object per library
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dev = x.device
    xq = torch.empty(x.shape, device=dev, dtype=torch.int8)
    scale = torch.empty((n, 1, 1, 1), device=dev, dtype=torch.float32)
    stat_partial = torch.empty((n, p1, groups, 2), device=dev, dtype=torch.float32)
    stats = torch.empty((n, groups, 2), device=dev, dtype=torch.float32)
    amax_partial = torch.empty((n, p2), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), gamma_nc.data_ptr(), beta_nc.data_ptr(), stat_partial.data_ptr(),
             stats.data_ptr(), amax_partial.data_ptr(), xq.data_ptr(), scale.data_ptr(),
             n, s, c, groups, rows1, p1, ty1, 8, rows2, p2, ty2, float(eps),
             int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_quant kernel launch failed: CUDA error {err}")
    launches += 1
    return xq, scale


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
