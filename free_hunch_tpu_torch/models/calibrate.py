"""Static int8 activation-scale calibration (``quant="int8_static"``).

Counterpart of ``free_hunch_tpu/models/calibrate.py`` (:66-280). The
dynamic int8 torso computes a per-sample abs-max for every quantised
activation; the static torso reads a calibrated scalar per (site, sigma
stage) instead:

1. run the guided sampler once with the DYNAMIC int8 model, keeping the
   trajectory (the states every denoiser call sees);
2. re-apply the denoiser at every (sigma stage, state) with the
   ``int8_calib`` model, whose sites record their batch abs-max;
3. per stage, scale = margin * amax / 127; the table holds, per site, the
   scales of all stages.

The table is (sigmas (S,) f32 ascending, {site: (S,) f32}), sites being the
torch module names of the int8 layers. ``wrap_precond(..., qscales=table)``
then selects a stage by nearest sigma at every call (``models/precond.py``).
``models/convert.py`` carries a table to and from the JAX package's form.

The cache key (``qscales_cache_key``) holds a hash of the calibration's
actual sigma grid and a tag of the operator it replayed, so a table is never
reused for another schedule or operator.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from free_hunch_tpu_torch import resolve_device
from free_hunch_tpu_torch.models.unet import create_model
from free_hunch_tpu_torch.ops.quant import _QuantSite

QScales = Tuple[np.ndarray, Dict[str, np.ndarray]]


def _build(model_args: dict, state_dict: dict, quant: str, dtype, dev) -> torch.nn.Module:
    with torch.device(dev):
        model = create_model(dtype=dtype, remat=False, quant=quant, **model_args)
    model.load_state_dict(state_dict)
    return model.eval().requires_grad_(False)


def calibration_stages(xs: dict):
    """(sigma, j, ratio) per denoiser call of a schedule: the state is
    ``ratio`` times the extended trajectory's entry j (0: the initial noise
    state, j >= 1: the state after step j-1). With the default no-churn
    schedule x_hat_i = scale_ratio_i * x_{i-1}; the Heun corrector state
    differs from x_{i+1} by O(h^2), which the margin covers."""
    sigma_hat = np.asarray(xs["sigma_hat"], np.float64)
    sigma_prime = np.asarray(xs["sigma_prime"], np.float64)
    scale_ratio = np.asarray(xs["scale_ratio"], np.float64)
    use_heun = np.asarray(xs["use_heun"], bool)
    stages = []
    for i in range(len(sigma_hat)):
        stages.append((float(sigma_hat[i]), i, float(scale_ratio[i])))
        if use_heun[i]:
            stages.append((float(sigma_prime[i]), i + 1, 1.0))
    return stages


def calibrate_qscales(model_args: dict, state_dict: dict, mechanism, noise: torch.Tensor,
                      y: torch.Tensor, xs: dict, sigma0_scaled: float,
                      generator: Optional[torch.Generator] = None, *, dtype=torch.bfloat16,
                      margin: float = 1.0, precond_kind: str = "linear",
                      device=None) -> QScales:
    """Run the calibration of the module docstring.

    model_args: the parsed setup-file kwargs (``models/loading.parse_setup_txt``);
    state_dict: the model's weights under the reference torch names;
    mechanism / noise / y / xs / sigma0_scaled / generator: what the
    production ``sample_loop`` call receives, so that every site sees
    representative activations. Returns (sigmas (S,) f32 ascending, table).
    """
    from free_hunch_tpu_torch.models.loading import wrap_precond
    from free_hunch_tpu_torch.samplers.edm import sample_loop

    dev = resolve_device(device)
    dyn = wrap_precond(_build(model_args, state_dict, "int8", dtype, dev), model_args,
                       precond_kind)
    _, traj = sample_loop(dyn, mechanism, noise, y, xs, generator,
                          sigma0_scaled=sigma0_scaled, return_trajectory=True)
    del dyn
    calib = wrap_precond(_build(model_args, state_dict, "int8_calib", dtype, dev), model_args,
                         precond_kind)
    sites = {name: m for name, m in calib.model.named_modules() if isinstance(m, _QuantSite)}
    x0 = noise.float() * sigma0_scaled
    by_sigma: Dict[float, Dict[str, float]] = {}
    for sigma, j, ratio in calibration_stages(xs):
        for m in sites.values():
            m.amax = None
        with torch.no_grad():
            calib(ratio * (x0 if j == 0 else traj[j - 1]), sigma)
        amax = {name: float(m.amax) for name, m in sites.items()}
        key = float(np.float32(sigma))
        if key in by_sigma:
            amax = {k: max(v, by_sigma[key][k]) for k, v in amax.items()}
        by_sigma[key] = amax
    sigmas = np.asarray(sorted(by_sigma), np.float32)
    table = {name: np.maximum(np.asarray([by_sigma[float(s)][name] for s in sigmas],
                                         np.float32), np.float32(1e-12))
             * np.float32(margin / 127.0) for name in sites}
    return sigmas, table


# -- persistence --------------------------------------------------------------

def save_qscales(path: str, sigmas: np.ndarray, table: Dict[str, np.ndarray]) -> None:
    """Write a table as npz ("sigmas", "site/<name>"), atomically: a writer
    of its own temporary file, then a rename."""
    flat = {"site/" + k: np.asarray(v, np.float32) for k, v in table.items()}
    flat["sigmas"] = np.asarray(sigmas, np.float32)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **flat)
    os.replace(tmp, path)


def load_qscales(path: str) -> Optional[QScales]:
    """A saved table, or None when the file is absent or unreadable (an
    unreadable file is removed)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            sigmas = np.asarray(data["sigmas"], np.float32)
            table = {k[len("site/"):]: np.asarray(data[k], np.float32)
                     for k in data.files if k.startswith("site/")}
        return sigmas, table
    except (OSError, ValueError, KeyError, EOFError):
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def qscales_cache_key(state_dict_path: str, model_args: dict, xs: dict, res: int,
                      margin: float, operator_tag: str) -> str:
    """Cache path beside the checkpoint, keyed by the architecture, a hash
    of the calibration's sigma grid (every stage sigma of ``xs``), the
    operator the replay used, the resolution and the margin."""
    arch = hashlib.md5(repr(sorted(model_args.items())).encode()).hexdigest()[:10]
    grid = np.asarray([s for s, _, _ in calibration_stages(xs)], np.float32)
    ghash = hashlib.sha1(grid.tobytes()).hexdigest()[:10]
    m = ("%g" % margin).replace(".", "p")
    return f"{state_dict_path}.qscales.{arch}.g{ghash}.{operator_tag}.r{res}.m{m}.npz"


def merge_qscales(a: QScales, b: QScales) -> QScales:
    """Combine two tables site-wise by max (scales grow with the observed
    abs-max)."""
    (sa, ta), (sb, tb) = a, b
    if sa.shape != sb.shape or not np.allclose(sa, sb):
        raise ValueError("tables calibrated on different sigma grids")
    return sa, {k: np.maximum(ta[k], tb[k]) for k in ta}


def bench_qscales(state_dict_path: str, model_args: dict, state_dict: dict, *,
                  num_steps: int, res: int, batch: int = 8, dtype=torch.bfloat16,
                  margin: float = 1.1, precond_kind: str = "linear", n_draws: int = 3,
                  device=None) -> QScales:
    """Calibration table for the benchmark protocol: gaussian-blur operator
    (sigma_s 0.1, 61x61, intensity 3) and Free Hunch with the covariance
    guidance gradient (the trajectory's activation statistics, all that
    calibration needs, do not depend on the gradient mode; the cheap mode
    keeps the replay short). ``n_draws`` independent (measurement, noise)
    draws from seeded generators are max-merged; the JAX package measured
    3 draws at margin 1.1 as the defaults that keep clipping error at the
    noise level (its ``calibrate.py:229-234``). Cached beside the
    checkpoint. The schedule snaps to ``precond_kind``'s sigma grid, so a
    cosine table's cache key differs from a linear one's."""
    from free_hunch_tpu_torch.guidance import choose_conditioning_mechanism
    from free_hunch_tpu_torch.models.precond import PRECONDS
    from free_hunch_tpu_torch.operators import get_operator
    from free_hunch_tpu_torch.samplers.edm import prepare_schedule, required_cov_capacity

    dev = resolve_device(device)
    pre = PRECONDS[precond_kind](torch.nn.Identity(), img_resolution=res, img_channels=3)
    xs, s0 = prepare_schedule(
        round_sigma=pre.round_sigma, net_sigma_min=pre.sigma_min,
        net_sigma_max=pre.sigma_max, num_steps=num_steps, solver="heun",
        discretization="edm", schedule="linear", scaling="none")
    tag = "gaussian_blur-s0p1-k61-i3" + (f"-d{n_draws}" if n_draws != 1 else "")
    cache = qscales_cache_key(state_dict_path, model_args, xs, res, margin, tag)
    qs = load_qscales(cache)
    if qs is not None:
        return qs
    op = get_operator("gaussian_blur", in_shape=(1, 3, res, res), sigma_s=0.1,
                      kernel_size=61, intensity=3.0, device=dev)
    mech = choose_conditioning_mechanism("online_covariance")(
        cond_scaling=1.0, forward_operator=op, clip_x0_mean=False,
        image_base_covariance="dct_diagonal" if res == 256 else "dct_diagonal_noinfo",
        init_denoiser_variance=1.0, init_noise_variance=80.0**2, data_dim=3 * res * res,
        cov_capacity=required_cov_capacity(xs), solver_type="customcuda",
        guidance_gradient="covariance")
    for d in range(n_draws):
        gen = torch.Generator(device=dev).manual_seed(17 + 100 * d)
        cond = torch.rand((batch, 3, res, res), generator=gen, device=dev) * 2 - 1
        y = op.forward(cond, generator=gen)
        noise = torch.randn((batch, 3, res, res), generator=gen, device=dev)
        t = calibrate_qscales(model_args, state_dict, mech, noise, y, xs, s0, gen,
                              dtype=dtype, margin=margin, precond_kind=precond_kind,
                              device=dev)
        qs = t if qs is None else merge_qscales(qs, t)
    try:
        save_qscales(cache, *qs)
    except OSError:
        pass
    return qs
