"""FLOP accounting for the denoiser forward, and for one guided call.

Counterpart of the repository's ``count_flops.py``, which reads XLA's cost
analysis. Here the formulas of ``torch.utils.flop_counter`` count what PyTorch
dispatches: the products of convolutions, matmuls (linear layers,
attention, the DCT and the low-rank algebra) and
``scaled_dot_product_attention``, two operations per multiply-add.
Elementwise work, norms, softmax and FFTs are not counted, and neither are
the hand-written kernels, which launch outside the dispatcher: on the bf16
torso that is K1 (GroupNorm+SiLU), which has no products. So an int8
torso's K3 products would be missed: the tool counts the bf16 torso.

Usage:
  python -m free_hunch_tpu_torch.tools.count_flops [--batch 1] [--full-step]
      [--setup models/256x256_diffusion_uncond_setup.txt] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from free_hunch_tpu_torch import resolve_device

ROOT = Path(__file__).resolve().parents[2]
SETUP_256 = ROOT / "models" / "256x256_diffusion_uncond_setup.txt"
CKPT_256 = ROOT / "models" / "256x256_diffusion_uncond.pt"


class _FlopCounter(TorchDispatchMode):
    """Sums ``torch.utils.flop_counter``'s formulas over every operator
    dispatched inside it, backward included. It is ``FlopCounterMode``
    without its module tracker, whose hooks refuse ``autograd.grad`` with
    respect to a leaf, which the guidance vjp takes."""

    def __init__(self):
        super().__init__()
        self.by_op = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.by_op[str(func._overloadpacket)] += int(formula(*args, **kwargs, out_val=out))
        return out


def count_flops(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its products counted. Returns (its
    output, total FLOPs, FLOPs by ATen operator)."""
    mode = _FlopCounter()
    with mode:
        out = fn(*args, **kwargs)
    return out, sum(mode.by_op.values()), dict(mode.by_op)


def load_denoiser(setup: str, state_dict: Optional[str] = None, device=None, seed: int = 0):
    """The bf16-torso UNet of ``setup`` (the checkpoint where it exists,
    else seeded random weights) wrapped in the iDDPM linear preconditioner,
    as the driver builds it. Returns (precond, model_args)."""
    from free_hunch_tpu_torch.models import loading
    model, model_args = loading.load_model(
        str(state_dict or ""), str(setup), dtype=torch.bfloat16, init_random_if_missing=True,
        rng_seed=seed, device=resolve_device(device))
    return loading.wrap_precond(model, model_args, "linear"), model_args


def forward_flops(precond, batch: int, sigma: float = 10.0) -> dict:
    """FLOPs of one denoiser forward (no gradient) at ``batch``."""
    res = precond.img_resolution
    dev = next(precond.parameters()).device
    x = torch.zeros((batch, 3, res, res), device=dev)
    with torch.no_grad():
        _, total, by_op = count_flops(precond, x, sigma)
    return dict(flops_per_forward=total, by_operator=by_op)


def guided_call_flops(precond, batch: int, seed: int = 0) -> dict:
    """FLOPs of the first guided call of the paper's run (``bench.py``'s
    protocol: gaussian blur, sigma_s 0.1, Free Hunch with the DCT-diagonal
    prior and the tailored CG, vjp guidance, 30 Heun steps): the forward,
    the vjp through the UNet, the covariance algebra and the CG solve; a
    seeded measurement and noise."""
    from free_hunch_tpu_torch import randn
    from free_hunch_tpu_torch.guidance import choose_conditioning_mechanism
    from free_hunch_tpu_torch.operators import get_operator
    from free_hunch_tpu_torch.samplers.edm import prepare_schedule, required_cov_capacity
    res = precond.img_resolution
    dev = next(precond.parameters()).device
    op = get_operator(name="gaussian_blur", in_shape=(1, 3, res, res), sigma_s=0.1,
                      kernel_size=61, intensity=3.0, device=dev)
    xs, s0 = prepare_schedule(round_sigma=precond.round_sigma, net_sigma_min=precond.sigma_min,
                              net_sigma_max=precond.sigma_max, num_steps=30, solver="heun",
                              discretization="edm", schedule="linear", scaling="none")
    mech = choose_conditioning_mechanism("online_covariance")(
        cond_scaling=1.0, forward_operator=op, clip_x0_mean=False,
        image_base_covariance="dct_diagonal", init_denoiser_variance=1.0,
        init_noise_variance=80.0**2, data_dim=3 * res * res,
        cov_capacity=required_cov_capacity(xs), solver_type="customcuda", max_rtol=1.0,
        cg_maxiter=5000)
    gen = torch.Generator().manual_seed(seed)
    x = randn((batch, 3, res, res), gen, device=dev) * s0
    with torch.no_grad():
        y = op.forward(torch.clamp(randn((batch, 3, res, res), gen, device=dev) * 0.5, -1, 1),
                       noiseless=True)
    state = mech.init_state(batch, (3, res, res))
    (_, state), total, by_op = count_flops(mech, precond, x, y, float(xs["sigma_hat"][0]),
                                           state)
    return dict(flops_per_guided_call=total, by_operator=by_op, cg_niter=state.cg_niter)


def report(precond, model_args: dict, batch: int, full_step: bool = False) -> dict:
    """The JSON report: parameters, batch, resolution, device, the count
    (per forward, or per guided call with ``full_step``) and its operators."""
    counts = guided_call_flops(precond, batch) if full_step else forward_flops(precond, batch)
    key = "flops_per_guided_call" if full_step else "flops_per_forward"
    return dict(params=int(sum(p.numel() for p in precond.parameters())), batch=batch,
                resolution=int(model_args.get("image_size", precond.img_resolution)),
                device=str(next(precond.parameters()).device),
                **{key: counts[key], "g" + key: counts[key] / 1e9},
                **{k: v for k, v in counts.items() if k != key})


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--setup", default=str(SETUP_256))
    p.add_argument("--state-dict", default=str(CKPT_256))
    p.add_argument("--device", default=None, help="default cuda")
    p.add_argument("--full-step", action="store_true",
                   help="count one guided Free Hunch call, not just the UNet forward")
    args = p.parse_args(argv)
    precond, model_args = load_denoiser(args.setup, args.state_dict, args.device)
    out = report(precond, model_args, args.batch, args.full_step)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
