"""DDNM+ sampler: DDPM ancestral sampling with SVD null-space projection.

Counterpart of ``free_hunch_tpu/samplers/ddnm.py`` (:28-217):
``get_schedule_jump`` (the RePaint time-travel schedule), the operator
dispatch ``build_svd_operator``, the host schedule ``ddnm_schedule``, the
sampler ``ddnm_sample`` and the entry point ``ddnm_conditional_sampler``.
Like the JAX package, the sampler drives the *raw* epsilon-prediction UNet
on the DDPM index grid, not the EDM preconditioner.

The JAX package's ``lax.scan`` with a ``lax.cond`` per step becomes a Python
loop over the host schedule: each step's branch (the projection step, or
the time-travel re-noising step) is the schedule's host-side ``forward``
flag, so no step reads the device. The step scalars are float32, as the
JAX package casts them. Per-step noise comes from a ``torch.Generator``
unless a ``noise_seq`` is given.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from free_hunch_tpu_torch import use_full_f32
from free_hunch_tpu_torch.operators import assets
from free_hunch_tpu_torch.operators import svd as svd_ops

_F32 = np.float32


def get_schedule_jump(T_sampling: int, travel_length: int = 1,
                      travel_repeat: int = 1) -> List[int]:
    """RePaint jump schedule: the timesteps from T_sampling - 1 down to -1,
    each segment of ``travel_length`` revisited ``travel_repeat - 1`` times."""
    jumps = {}
    for j in range(0, T_sampling - travel_length, travel_length):
        jumps[j] = travel_repeat - 1
    t = T_sampling
    ts = []
    while t >= 1:
        t -= 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] -= 1
            for _ in range(travel_length):
                t += 1
                ts.append(t)
    ts.append(-1)
    assert ts[0] > ts[1] and ts[-1] == -1
    return ts


def build_svd_operator(operator_kwargs: dict, img_dim: int, generator=None, device=None):
    """The DDNM+ operator of ``operator_kwargs['name']``: gaussian blur
    (``Deblurring`` of the bundled 61x61 kernel), inpainting (a mask drawn
    from ``generator``, see ``svd.create_inpainting_operator``) or block
    super-resolution. Motion blur raises NotImplementedError, as upstream."""
    name = operator_kwargs["name"]
    if name == "gaussian_blur":
        return svd_ops.Deblurring(
            assets.gaussian_blur_kernel(), 3, img_dim,
            use_ddnm_kernel_params=bool(operator_kwargs.get("use_ddnm_kernel_params", False)),
            device=device)
    if name == "motion_blur":
        raise NotImplementedError("Motion blur not implemented for DDNM")
    if name == "inpainting":
        return svd_ops.create_inpainting_operator(3, img_dim, operator_kwargs["mask_opt"],
                                                  generator=generator, device=device)
    if name == "super_resolution":
        return svd_ops.SuperResolution(3, img_dim, int(operator_kwargs["scale_factor"]),
                                       device=device)
    raise ValueError(f"Operator {name} not supported for DDNM")


def ddnm_schedule(num_steps: int, M: int = 1000, beta_start=0.0001, beta_end=0.02,
                  travel_length: int = 1, travel_repeat: int = 1):
    """Host precomputation: per-step (at, at_next, is_forward) arrays, with
    alpha-bar on the zero-prepended beta grid."""
    betas = np.concatenate([[0.0], np.linspace(beta_start, beta_end, M)])
    alpha_bar = np.cumprod(1.0 - betas)  # index t+1 for timestep t
    skip = M // num_steps

    times = get_schedule_jump(num_steps, travel_length, travel_repeat)
    at, at_next, forward = [], [], []
    for i, j in zip(times[:-1], times[1:]):
        ii, jj = i * skip, j * skip
        if jj < 0:
            jj = -1
        at.append(alpha_bar[ii + 1])
        at_next.append(alpha_bar[jj + 1])
        forward.append(jj < ii)
    return np.asarray(at), np.asarray(at_next), np.asarray(forward, bool)


def ddnm_steps(num_steps: int, M: int = 1000, travel_length: int = 1,
               travel_repeat: int = 1) -> List[dict]:
    """The sampler's steps as host scalars: ``at``, ``at_next`` (float32, as
    the JAX package casts them), ``forward`` and the DDPM index ``t``."""
    at, at_next, fwd = ddnm_schedule(num_steps, M=M, travel_length=travel_length,
                                     travel_repeat=travel_repeat)
    skip = M // num_steps
    times = get_schedule_jump(num_steps, travel_length, travel_repeat)
    return [dict(at=_F32(a), at_next=_F32(an), forward=bool(f), t=float(_F32(i * skip)))
            for a, an, f, i in zip(at, at_next, fwd, times[:-1])]


def ddnm_step(eps_fn: Callable, a_funcs, y: torch.Tensor, xt: torch.Tensor,
              x0_pred: torch.Tensor, step: dict, eps: torch.Tensor, *,
              sigma_y: float, eta: float):
    """One step of the sampler: (x_next, x0_pred). A forward step runs the
    UNet, Eq. 12's x0 prediction, Eq. 17's null-space correction and Eq.
    51's ancestral step with the split noise; a time-travel step re-noises
    the last x0 prediction up to ``at_next``. ``eps`` is the step's fresh
    standard-normal draw."""
    at, at_next = step["at"], step["at_next"]
    b = xt.shape[0]
    if not step["forward"]:
        xt_next = float(np.sqrt(at_next)) * x0_pred + eps * float(np.sqrt(_F32(1) - at_next))
        return xt_next, x0_pred
    t_b = torch.full((b,), step["t"], dtype=torch.float32, device=xt.device)
    et = eps_fn(xt, t_b)
    # Eq. 12
    x0_t = (xt - et * float(np.sqrt(_F32(1) - at))) / float(np.sqrt(at))
    sigma_t = np.sqrt(_F32(1) - at_next)
    a = np.sqrt(at_next)
    # Eq. 17: the null-space corrected x0
    resid = a_funcs.A(x0_t.reshape(b, -1)) - y.reshape(b, -1)
    corr = a_funcs.Lambda(a_funcs.A_pinv(resid).reshape(b, -1), a, sigma_y, sigma_t, eta)
    x0_hat = x0_t - corr.reshape(x0_t.shape)
    # Eq. 51: the ancestral step with the split noise
    noise_term = a_funcs.Lambda_noise(eps.reshape(b, -1), a, sigma_y, sigma_t, eta,
                                      et.reshape(b, -1)).reshape(x0_t.shape)
    return float(a) * x0_hat + noise_term, x0_t


def ddnm_sample(eps_fn: Callable, a_funcs, noise: torch.Tensor, y: torch.Tensor, *,
                num_steps: int, sigma_y: float, eta: float = 1.0, M: int = 1000,
                travel_length: int = 1, travel_repeat: int = 1,
                generator: Optional[torch.Generator] = None,
                return_trajectory: bool = False, noise_seq=None):
    """Run DDNM+ from pure noise. ``eps_fn(x, t_float_batch)`` -> epsilon
    (B, C, H, W): the raw UNet with the variance channel stripped. ``y``:
    (B, n) measurement. Returns (x_final, [x0_last]), or with
    ``return_trajectory`` (x_final, the (T, B, C, H, W) stack of iterates).

    Each step draws one standard-normal tensor from ``generator`` (default:
    a generator on noise's device seeded 0), in either branch, as upstream
    calls ``randn_like`` once per step; ``noise_seq`` (T, B, C, H, W)
    supplies those draws instead. Sets the port's precision policy
    (``use_full_f32``)."""
    use_full_f32()
    steps = ddnm_steps(num_steps, M=M, travel_length=travel_length,
                       travel_repeat=travel_repeat)
    dev = noise.device
    if noise_seq is not None:
        if noise_seq.shape[0] != len(steps):
            raise ValueError(f"noise_seq must provide one draw per step "
                             f"({noise_seq.shape[0]} != {len(steps)})")
        noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32, device=dev)
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    xt = noise.float()
    x0_pred = torch.zeros_like(xt)
    traj = []
    with torch.no_grad():
        for i, step in enumerate(steps):
            eps = (noise_seq[i] if noise_seq is not None else
                   torch.randn(xt.shape, generator=generator, dtype=xt.dtype, device=dev))
            xt, x0_pred = ddnm_step(eps_fn, a_funcs, y, xt, x0_pred, step, eps,
                                    sigma_y=sigma_y, eta=eta)
            if return_trajectory:
                traj.append(xt)
    return xt, (torch.stack(traj) if return_trajectory else [x0_pred])


def ddnm_conditional_sampler(eps_fn: Callable, noise: torch.Tensor, cond_images: torch.Tensor,
                             operator_kwargs: dict, noise_kwargs: dict, *,
                             num_steps: int = 18, eta: float = 1.0,
                             generator: Optional[torch.Generator] = None,
                             measurement_generator: Optional[torch.Generator] = None,
                             mask_generator=None, travel_length: int = 1,
                             travel_repeat: int = 1, **other):
    """The DDNM+ entry point, on noise's device: builds the SVD operator,
    takes the measurement y = A x + sigma_y n, runs DDNM+ and returns
    (x, [x0_last], y_for_output). ``measurement_generator`` draws n and
    ``generator`` the sampler's noise (each default: a generator on the
    device seeded 0 and 1, where the JAX package folds its key with 0 and
    1); ``mask_generator`` draws an inpainting mask. The remaining
    ``**other`` keys are the EDM sampler's options, which DDNM+ ignores."""
    img_dim = noise.shape[-1]
    b = noise.shape[0]
    dev = noise.device
    a_funcs = build_svd_operator(operator_kwargs, img_dim, generator=mask_generator,
                                 device=dev)
    sigma_y = float(noise_kwargs.get("sigma", 0.0))
    if measurement_generator is None:
        measurement_generator = torch.Generator(device=dev).manual_seed(0)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(1)
    use_full_f32()
    cond = cond_images.float()
    with torch.no_grad():
        y = a_funcs.A(cond.reshape(b, -1))
        y = y + sigma_y * torch.randn(y.shape, generator=measurement_generator,
                                      dtype=y.dtype, device=dev)
        name = operator_kwargs["name"]
        if name == "inpainting":
            y_for_output = a_funcs.A_with_zeros(cond.reshape(b, -1)).reshape(cond.shape)
        elif name == "super_resolution":
            sf = int(operator_kwargs["scale_factor"])
            y_for_output = y.reshape(b, 3, img_dim // sf, img_dim // sf)
        else:
            y_for_output = y.reshape(cond.shape)
    x, x_all = ddnm_sample(eps_fn, a_funcs, noise, y, num_steps=num_steps, sigma_y=sigma_y,
                           eta=eta, travel_length=travel_length,
                           travel_repeat=travel_repeat, generator=generator)
    return x, x_all, y_for_output
