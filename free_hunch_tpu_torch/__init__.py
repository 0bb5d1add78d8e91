"""free_hunch_tpu_torch — the PyTorch/CUDA port of ``free_hunch_tpu``.

Guided-diffusion inverse problems with online denoiser-covariance estimation
("Free Hunch", Rissanen et al., ICLR 2025) on one NVIDIA H100. The module
layout mirrors the JAX package (``ops/``, ``guidance/``, ``models/``,
``operators/``, ``samplers/``) so each counterpart is found under the same
name. The port imports torch, numpy and scipy only.

Entry points take ``device=None``, which means CUDA: they raise when no card
is present and never continue on the CPU. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("free_hunch_tpu_torch: CUDA device requested (the "
                           "default) but torch.cuda.is_available() is False; "
                           "pass device='cpu' explicitly for a CPU run")
    return dev


def use_full_f32() -> None:
    """Precision policy of the port: float32 matmuls and convolutions run in
    full float32, never TF32. The JAX package runs the DCT and the low-rank
    covariance algebra at ``Precision.HIGHEST`` (the BFGS recursion amplifies
    ~1e-3 matmul error into a diverging state), and its f32 output conv is
    f32. cuBLAS already defaults to full f32; cuDNN defaults to TF32 for f32
    convolutions, so both flags are set here. bf16 work is unaffected.
    ``models.loading.load_model`` and ``samplers.edm.sample_loop`` call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_full_f32(t: torch.Tensor) -> None:
    """Raise if f32 CUDA work on ``t`` would run in TF32 (matmul or conv)."""
    if t.is_cuda and t.dtype == torch.float32 and (
            torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("the port needs full-f32 matmuls and convolutions: "
                           "call free_hunch_tpu_torch.use_full_f32() first")


def randn(shape, generator=None, dtype=torch.float32, device=None) -> torch.Tensor:
    """A standard-normal draw from ``generator`` (default: torch's global
    generator of ``device``), made on the generator's device and moved to
    ``device``: a CPU generator gives a run on the card the same draws as
    a run on the CPU. A CPU draw bound for the card is made in pinned
    memory and copied without blocking, so the host does not wait for the
    card's queued work at every draw."""
    where = torch.device(generator.device if generator is not None else device or "cpu")
    dest = torch.device(device) if device is not None else where
    if where.type == "cpu" and dest.type == "cuda":
        z = torch.randn(tuple(shape), generator=generator, dtype=dtype, pin_memory=True)
        return z.to(dest, non_blocking=True)
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=where).to(dest)
