"""Port parity for the int8 slice: 3 Heun steps of Free Hunch guided
deblurring at 32 px through the tiny UNet on the fused int8 torso (K2 -> K3
on the card, their plain versions here), against the JAX package's
``sample_scan`` with FREE_HUNCH_FUSED_GN_QUANT=1 and the same weights,
noise and measurement; the DCT prior of tests/test_torch_freehunch.py, vjp
guidance, CG recycling the previous stage's solution."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu.samplers import edm as jedm
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
from free_hunch_tpu_torch.samplers import edm as tedm
from tests._torch_parity import RES, quant_pair
from tests.test_torch_freehunch import SHAPE, _mechs, prior_dir  # noqa: F401

F32 = np.float32


def run_int8_slice(prior_dir, monkeypatch, solver="heun", quant="int8", fused=True):
    """Both packages through the 3-step slice; returns the JAX and port
    trajectories, each step's max |x| in the JAX one, and the CG niter of
    each."""
    jm_net, params, tm_net = quant_pair(quant, fused=fused, remat=True)
    pre_j = JPrecond(jm_net, img_resolution=RES, img_channels=3)
    pre_t = TPrecond(tm_net, img_resolution=RES, img_channels=3)
    xs, s0 = jedm.prepare_schedule(
        round_sigma=pre_j.round_sigma, net_sigma_min=pre_j.sigma_min,
        net_sigma_max=pre_j.sigma_max, num_steps=3, solver=solver, discretization="edm",
        schedule="linear", scaling="none")
    jm, tm = _mechs(prior_dir, cov_capacity=jedm.required_cov_capacity(xs),
                    cg_warm_start="prev", guidance_gradient="vjp")
    rng = np.random.default_rng(1)
    noise = rng.normal(size=SHAPE).astype(F32)
    y = rng.uniform(-1, 1, SHAPE).astype(F32)
    if fused:
        monkeypatch.setenv("FREE_HUNCH_FUSED_GN_QUANT", "1")

    @jax.jit
    def run(noise_, y_):
        den = lambda x, s: pre_j.apply(params, x, s)  # noqa: E731
        return jedm.sample_scan(den, jm, noise_, y_, xs, jax.random.PRNGKey(0),
                                sigma0_scaled=s0, return_trajectory=True,
                                collect_diagnostics=True)

    _, jtraj, jdiag = run(jnp.asarray(noise), jnp.asarray(y))
    monkeypatch.delenv("FREE_HUNCH_FUSED_GN_QUANT", raising=False)
    tx, ttraj, tdiag = tedm.sample_loop(pre_t, tm, torch.as_tensor(noise),
                                        torch.as_tensor(y), xs, sigma0_scaled=s0,
                                        return_trajectory=True, collect_diagnostics=True)
    assert torch.isfinite(tx).all() and torch.equal(tx, ttraj[-1])
    jtraj = np.asarray(jtraj)
    return (jtraj, ttraj.numpy(), np.abs(jtraj).reshape(3, -1).max(axis=1),
            np.asarray(jdiag["cg_niter"]), tdiag["cg_niter"].numpy())


def test_int8_fused_slice_three_heun_steps_matches_sample_scan(prior_dir, monkeypatch):
    """3 Heun steps (sigma 80 -> 3.46 -> 0.002 -> 0), the bench's solver:
    equal CG niter at every stage. Every guided call sees the denoiser
    through int8 codes that can flip between the packages
    (tests/test_torch_unet_int8.py holds one forward to 2e-3 of its max and
    the pullback to 1e-2), and the guided step carries that into x: steps 0
    and 1 are held to 2e-2 of their own max |x| (observed 7.1e-3 of 16.5
    and 1.04e-2 of 294). The random weights leave |x| ~ 294 at sigma 0.002,
    and the last step maps x into the clipped denoiser output, where an
    element whose input moved by the step-1 error can cross the clip: the
    last step is held by its mean |dx|, 1e-2 (observed 2.0e-3; the Euler
    test below holds a last step by its max)."""
    jtraj, ttraj, scale, jn, tn = run_int8_slice(prior_dir, monkeypatch, "heun")
    assert tn.shape == jn.shape == (3, 2)
    np.testing.assert_array_equal(tn, jn)
    for i in range(2):
        np.testing.assert_allclose(ttraj[i], jtraj[i], rtol=0, atol=2e-2 * scale[i],
                                   err_msg=f"step {i}")
    assert float(np.abs(ttraj[2] - jtraj[2]).mean()) <= 1e-2


def test_int8_fused_slice_three_euler_steps_matches_sample_scan(prior_dir, monkeypatch):
    """3 Euler steps: x stays within |x| <= 15, so every step, the last
    included, is held to 2e-2 of its own max |x| (observed 1.6e-3, 7.4e-3
    and 1.08e-2), with equal CG niter."""
    jtraj, ttraj, scale, jn, tn = run_int8_slice(prior_dir, monkeypatch, "euler")
    np.testing.assert_array_equal(tn, jn)
    for i in range(3):
        np.testing.assert_allclose(ttraj[i], jtraj[i], rtol=0, atol=2e-2 * scale[i],
                                   err_msg=f"step {i}")
