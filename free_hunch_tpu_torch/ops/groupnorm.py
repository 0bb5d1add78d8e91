"""GroupNorm(32)(+SiLU) over channels-last activations: the hand-written
Hopper kernel ``csrc/groupnorm.cu``, its plain PyTorch version, and the
autograd wrapper the UNet calls.

Replaces the TPU kernel ``free_hunch_tpu/ops/pallas_groupnorm.py``
(``_stats_kernel`` :70-85 and ``_apply_kernel`` :88-106, launched by
``_pallas_groupnorm`` :109-144, entry ``groupnorm_silu`` :166). It computes
that file's ``_reference`` (:38-59), with a centred variance instead of the
TPU kernel's ``E[x^2] - E[x]^2``.

Bound: device-memory bytes (~10 flops per element against 2 or 4 bytes).
The least traffic is one read of x and one write of y; the kernel reads x
twice and writes y once (statistics pass, then apply pass), because a whole
sample's statistics must be complete before any element is normalised.
Every ``GroupNorm32`` of the UNet lands here: 101 per forward of the 256 px
model (42 ResBlocks x 2, 16 attention norms, the final norm), the largest on
the (N, 256*256, 512) bf16 decoder concat. ``chip_smoke.py`` counts the
bytes of every call of one forward from its shapes and prints the bound.

The gradient is the JAX package's ``custom_vjp`` (:147-163): no backward
kernel; the backward recomputes the plain version under autograd and pulls
the cotangent back through it.
"""
from __future__ import annotations

import ctypes

import torch

# Calls that launched the CUDA kernel sequence (stats, finalize, apply).
# Plain-version calls on CPU tensors do not count.
launches = 0

_SM_COUNT_H100 = 132
_MAX_SHARED = 48 * 1024


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


def _plan(n: int, s: int, c: int, vec: int):
    """Block shape and chunking: whole C-wide rows per block (C / vec
    threads across, enough rows down for 256 threads) and about four blocks
    per SM in each of the two streaming passes."""
    tx = c // vec
    ty = max(1, 256 // tx)
    want = max(1, -(-4 * _SM_COUNT_H100 // n))
    rows = max(-(-s // min(want, 1024)), ty)
    return ty, rows, -(-s // rows)


def groupnorm_silu_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        groups: int = 32, eps: float = 1e-5,
                        apply_silu: bool = True) -> torch.Tensor:
    """Launch the kernel on a contiguous channels-last (N, ..., C) CUDA
    tensor. Raises on anything the kernel does not take."""
    global launches
    from free_hunch_tpu_torch.ops import _nvcc

    if not x.is_cuda:
        raise ValueError("groupnorm_silu_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"groupnorm kernel takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm kernel needs a contiguous channels-last tensor")
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // max(n * c, 1)
    vec = 8 if x.dtype == torch.bfloat16 else 4
    if c % groups or c % vec or (c // vec) > 1024:
        raise ValueError(f"groupnorm kernel: C={c} must be a multiple of "
                         f"groups={groups} and {vec}, and C/{vec} <= 1024")
    if groups * 8 > 1024 or s * (c // groups) >= 2 ** 24:
        raise ValueError(f"groupnorm kernel: groups={groups}, S*C/G="
                         f"{s * (c // groups)} out of range")
    if x.data_ptr() % 16:
        raise ValueError("groupnorm kernel needs a 16-byte aligned input")
    for t in (gamma, beta):
        if t.device != x.device or t.dtype != torch.float32 or \
                t.shape != (c,) or not t.is_contiguous():
            raise ValueError("gamma/beta must be contiguous f32 (C,) on x's device")
    ty, rows, p = _plan(n, s, c, vec)
    if (2 * ty * c + ty) * 4 > _MAX_SHARED:
        raise ValueError(f"groupnorm kernel: C={c} needs too much shared memory")
    fn = _nvcc.load("groupnorm").fh_groupnorm_forward
    if fn.argtypes is None:  # ctypes keeps one function object per library
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    partial = torch.empty((n, p, groups, 2), device=x.device, dtype=torch.float32)
    stats = torch.empty((n, groups, 2), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             partial.data_ptr(), stats.data_ptr(), n, s, c, groups, rows, p, ty, 8,
             float(eps), int(apply_silu), int(x.dtype == torch.bfloat16), stream)
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
