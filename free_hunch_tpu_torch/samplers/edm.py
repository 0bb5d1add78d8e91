"""EDM Heun/Euler probability-flow ODE sampler with guided conditioning.

Counterpart of ``free_hunch_tpu/samplers/edm.py``: ``get_sigma_steps`` and
``prepare_schedule`` are the port's own copies of the host numpy schedule
code (outputs equal the JAX package's bit for bit), ``required_cov_capacity``
likewise (:41-211). ``sample_scan`` (:214-306) becomes ``sample_loop``, a
Python loop over the steps: each step is Heun or Euler as the host schedule
says, so the final Euler step is simply the last iteration.
``conditional_sampler`` (:309-343) is the one-shot entry point.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from free_hunch_tpu_torch import use_full_f32


def _vp_sigma(beta_d, beta_min):
    return lambda t: np.sqrt(np.expm1(0.5 * beta_d * t**2 + beta_min * t))


def _vp_sigma_deriv(beta_d, beta_min, sigma):
    return lambda t: 0.5 * (beta_min + beta_d * t) * (sigma(t) + 1 / sigma(t))


def _vp_sigma_inv(beta_d, beta_min):
    return lambda s: (np.sqrt(beta_min**2 + 2 * beta_d * np.log(s**2 + 1)) - beta_min) / beta_d


def get_sigma_steps(discretization: str, num_steps: int, sigma_min: float,
                    sigma_max: float, *, vp_beta_d=19.9, vp_beta_min=0.1, rho=7.0,
                    M=1000, C_1=0.001, C_2=0.008, epsilon_s=1e-3) -> np.ndarray:
    """The 5 time-step discretizations."""
    idx = np.arange(num_steps, dtype=np.float64)
    if discretization == "vp":
        t = 1 + idx / (num_steps - 1) * (epsilon_s - 1)
        return _vp_sigma(vp_beta_d, vp_beta_min)(t)
    if discretization == "ve":
        t = sigma_max**2 * ((sigma_min**2 / sigma_max**2) ** (idx / (num_steps - 1)))
        return np.sqrt(t)
    if discretization == "iddpm":
        u = np.zeros(M + 1)
        alpha_bar = lambda j: np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2  # noqa: E731
        for j in range(M, 0, -1):
            u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1)
        uf = u[(u >= sigma_min) & (u <= sigma_max)]
        return uf[np.round((len(uf) - 1) / (num_steps - 1) * idx).astype(int)]
    if discretization == "ddpm_linear":
        betas = np.linspace(0.0001, 0.02, M)
        alpha_bar = np.cumprod(1 - betas)[::-1]
        u = np.sqrt((1 - alpha_bar) / alpha_bar)
        uf = u[(u >= sigma_min) & (u <= sigma_max)]
        return uf[np.round((len(uf) - 1) / (num_steps - 1) * idx).astype(int)]
    if discretization != "edm":
        raise ValueError(f"unknown discretization {discretization!r}")
    return (sigma_max ** (1 / rho)
            + idx / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho


class _Schedule(NamedTuple):
    sigma: Callable
    sigma_deriv: Callable
    sigma_inv: Callable
    s: Callable
    s_deriv: Callable


def _build_schedule(schedule: str, scaling: str, vp_beta_d, vp_beta_min) -> _Schedule:
    if schedule == "vp":
        sigma = _vp_sigma(vp_beta_d, vp_beta_min)
        sigma_deriv = _vp_sigma_deriv(vp_beta_d, vp_beta_min, sigma)
        sigma_inv = _vp_sigma_inv(vp_beta_d, vp_beta_min)
    elif schedule == "ve":
        sigma = lambda t: np.sqrt(t)  # noqa: E731
        sigma_deriv = lambda t: 0.5 / np.sqrt(t)  # noqa: E731
        sigma_inv = lambda s: s**2  # noqa: E731
    elif schedule == "linear":
        sigma = lambda t: t  # noqa: E731
        sigma_deriv = lambda t: 1.0  # noqa: E731
        sigma_inv = lambda s: s  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if scaling == "vp":
        s_fn = lambda t: 1 / np.sqrt(1 + sigma(t) ** 2)  # noqa: E731
        s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * (s_fn(t) ** 3)  # noqa: E731
    elif scaling == "none":
        s_fn = lambda t: 1.0  # noqa: E731
        s_deriv = lambda t: 0.0  # noqa: E731
    else:
        raise ValueError(f"unknown scaling {scaling!r}")
    return _Schedule(sigma, sigma_deriv, sigma_inv, s_fn, s_deriv)


def prepare_schedule(
    *, round_sigma: Callable, net_sigma_min: float, net_sigma_max: float,
    num_steps: int = 18, sigma_min: Optional[float] = None,
    sigma_max: Optional[float] = None, rho: float = 7.0,
    solver: str = "heun", discretization: str = "edm", schedule: str = "linear",
    scaling: str = "none", epsilon_s: float = 1e-3, C_1: float = 0.001,
    C_2: float = 0.008, M: int = 1000, alpha: float = 1.0,
    S_churn: float = 0.0, S_min: float = 0.0, S_max: float = float("inf"),
    S_noise: float = 1.0,
):
    """Host-side schedule precomputation (float64 numpy). Returns (xs,
    sigma0_scaled): ``xs`` holds the per-step arrays ``sample_loop`` reads
    and ``sigma0_scaled`` = sigma(t_0) s(t_0) scales the initial noise."""
    if solver not in ("euler", "heun"):
        raise ValueError(f"unknown solver {solver!r}")
    if discretization not in ("vp", "ve", "iddpm", "edm", "ddpm_linear"):
        raise ValueError(f"unknown discretization {discretization!r}")

    vp_def = _vp_sigma(19.9, 0.1)
    if sigma_min is None:
        sigma_min = {"vp": vp_def(epsilon_s), "ve": 0.02, "iddpm": 0.002,
                     "edm": 0.002, "ddpm_linear": 0.002}[discretization]
    if sigma_max is None:
        sigma_max = {"vp": vp_def(1.0), "ve": 100.0, "iddpm": 81.0,
                     "edm": 80.0, "ddpm_linear": 81.0}[discretization]
    sigma_min = max(sigma_min, net_sigma_min)
    sigma_max = min(sigma_max, net_sigma_max)

    vp_beta_d = 2 * (np.log(sigma_min**2 + 1) / epsilon_s
                     - np.log(sigma_max**2 + 1)) / (epsilon_s - 1)
    vp_beta_min = np.log(sigma_max**2 + 1) - 0.5 * vp_beta_d
    sch = _build_schedule(schedule, scaling, vp_beta_d, vp_beta_min)

    sigma_steps = get_sigma_steps(discretization, num_steps, sigma_min, sigma_max,
                                  vp_beta_d=vp_beta_d, vp_beta_min=vp_beta_min,
                                  rho=rho, M=M, C_1=C_1, C_2=C_2, epsilon_s=epsilon_s)
    snapped = np.asarray(round_sigma(sigma_steps), np.float64)
    t_steps = np.concatenate([sch.sigma_inv(snapped), [0.0]])

    t_hat = np.empty(num_steps)
    churn_std = np.empty(num_steps)
    scale_ratio = np.empty(num_steps)
    for i in range(num_steps):
        t_cur = t_steps[i]
        gamma = (min(S_churn / num_steps, np.sqrt(2) - 1)
                 if S_min <= sch.sigma(t_cur) <= S_max else 0.0)
        th = sch.sigma_inv(np.asarray(round_sigma(sch.sigma(t_cur)
                                                  + gamma * sch.sigma(t_cur)), np.float64))
        t_hat[i] = th
        churn_std[i] = (np.sqrt(max(sch.sigma(th)**2 - sch.sigma(t_cur)**2, 0.0))
                        * sch.s(th) * S_noise)
        scale_ratio[i] = sch.s(th) / sch.s(t_cur)
    t_next = t_steps[1:]
    h = t_next - t_hat
    sigma_hat = np.array([sch.sigma(t) for t in t_hat])
    t_prime = t_hat + alpha * h
    sigma_prime = np.array([sch.sigma(t) for t in t_prime])
    use_heun = np.array([(solver == "heun") and (i < num_steps - 1)
                         for i in range(num_steps)])
    with np.errstate(divide="ignore", invalid="ignore"):
        c1 = np.array([sch.sigma_deriv(t) / sch.sigma(t) + sch.s_deriv(t) / sch.s(t)
                       for t in t_prime])
        c2 = np.array([sch.sigma_deriv(t) * sch.s(t) / sch.sigma(t) for t in t_prime])
    c1 = np.where(use_heun, np.nan_to_num(c1), 0.0)
    c2 = np.where(use_heun, np.nan_to_num(c2), 0.0)

    xs = dict(
        sigma_hat=np.asarray(sigma_hat, np.float32),
        churn_std=np.asarray(churn_std, np.float32),
        scale_ratio=np.asarray(scale_ratio, np.float32),
        h=np.asarray(h, np.float32),
        sigma_prime=np.asarray(sigma_prime, np.float32),
        c1=np.asarray(c1, np.float32), c2=np.asarray(c2, np.float32),
        use_heun=use_heun,
    )
    sigma0_scaled = float(sch.sigma(t_steps[0]) * sch.s(t_steps[0]))
    return xs, sigma0_scaled


def required_cov_capacity(xs: dict, lower: float = 1.0, upper: float = 10.0,
                          do_space_updates: bool = True, slack: int = 2) -> int:
    """Exact low-rank capacity the Free Hunch state needs for a schedule:
    two columns per guidance call whose sigma lies strictly inside the
    space-update window, plus slack."""
    if not do_space_updates:
        return 2
    sig = np.concatenate([
        np.asarray(xs["sigma_hat"], np.float64),
        np.asarray(xs["sigma_prime"], np.float64)[np.asarray(xs["use_heun"], bool)],
    ])
    n_window = int(np.sum((sig > lower) & (sig < upper)))
    return max(2 * n_window + slack, 2)


def sample_loop(denoise: Callable, mechanism, noise: torch.Tensor, y: torch.Tensor,
                xs: dict, generator: Optional[torch.Generator] = None, *,
                sigma0_scaled: float, alpha: float = 1.0,
                return_trajectory: bool = False, collect_diagnostics: bool = False):
    """The sampling loop: one or two guided denoiser calls per step (Heun,
    or Euler where ``xs['use_heun']`` is False). Churn noise, where the
    schedule has any (``S_churn > 0``), comes from ``generator``.

    Returns (x_final, trajectory) and, with ``collect_diagnostics``, a third
    value: the JAX package's dict (``cg_niter`` (num_steps, 2) int32,
    ``cg_resnorm`` and ``cg_optfrac`` (num_steps, 2) f32; column 1 is
    -1 / 0 / 1 on Euler steps) plus ``host_syncs``, the CG loop's device
    reads over the run. Sets the port's precision policy (``use_full_f32``)."""
    use_full_f32()
    use_heun = np.asarray(xs["use_heun"], bool)
    num_steps = use_heun.shape[0]
    gstate = mechanism.init_state(noise.shape[0], noise.shape[1:])
    x = noise.float() * sigma0_scaled
    traj = [x] if not return_trajectory else []
    niter, resn, optf = [], [], []
    host_syncs = 0
    dev = x.device
    for i in range(num_steps):
        step = {k: float(v[i]) for k, v in xs.items() if k != "use_heun"}
        x_hat = step["scale_ratio"] * x
        if step["churn_std"] != 0.0:
            eps = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=dev)
            x_hat = x_hat + step["churn_std"] * eps
        denoised, gstate = mechanism(denoise, x_hat, y, step["sigma_hat"], gstate)
        n1, r1, o1 = gstate.cg_niter, gstate.cg_resnorm, gstate.cg_optfrac
        host_syncs += gstate.cg_host_syncs
        d_cur = (x_hat - denoised) / step["sigma_hat"]
        if use_heun[i]:
            x_prime = x_hat + alpha * step["h"] * d_cur
            denoised2, gstate = mechanism(denoise, x_prime, y, step["sigma_prime"], gstate)
            n2, r2, o2 = gstate.cg_niter, gstate.cg_resnorm, gstate.cg_optfrac
            host_syncs += gstate.cg_host_syncs
            d_prime = step["c1"] * x_prime - step["c2"] * denoised2
            x = x_hat + step["h"] * ((1 - 1 / (2 * alpha)) * d_cur
                                     + 1 / (2 * alpha) * d_prime)
        else:
            n2, r2, o2 = -1, torch.zeros((), device=dev), torch.ones((), device=dev)
            x = x_hat + step["h"] * d_cur
        if return_trajectory:
            traj.append(x)
        if collect_diagnostics:
            niter.append([n1, n2])
            resn.append(torch.stack([r1, r2]))
            optf.append(torch.stack([o1, o2]))
    if return_trajectory:
        traj = torch.stack(traj)
    if collect_diagnostics:
        diag = dict(cg_niter=torch.tensor(niter, dtype=torch.int32),
                    cg_resnorm=torch.stack(resn).cpu(),
                    cg_optfrac=torch.stack(optf).cpu(),
                    host_syncs=host_syncs)
        return x, traj, diag
    return x, traj


def conditional_sampler(denoise: Callable, noise: torch.Tensor, cond_images: torch.Tensor,
                        operator, mechanism, *, round_sigma: Callable, net_sigma_min: float,
                        net_sigma_max: float, generator: Optional[torch.Generator] = None,
                        measurement_generator: Optional[torch.Generator] = None,
                        alpha: float = 1.0, return_trajectory: bool = False,
                        **schedule_kwargs):
    """One-shot entry point: prepare the schedule, take the measurement
    y = operator.forward(cond_images) with its noise drawn from
    ``measurement_generator`` (``None``: noiseless), then run
    ``sample_loop`` with its churn noise from ``generator``. The two
    generators stand for the JAX package's two folds of one key. Returns
    (x_final, x_all, y)."""
    xs, sigma0_scaled = prepare_schedule(
        round_sigma=round_sigma, net_sigma_min=net_sigma_min,
        net_sigma_max=net_sigma_max, alpha=alpha, **schedule_kwargs)
    with torch.no_grad():
        y = operator.forward(cond_images, generator=measurement_generator)
    x_final, x_all = sample_loop(denoise, mechanism, noise, y, xs, generator,
                                 sigma0_scaled=sigma0_scaled, alpha=alpha,
                                 return_trajectory=return_trajectory)
    return x_final, x_all, y
