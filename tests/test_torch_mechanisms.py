"""Port parity for the seven stateless conditioning mechanisms (DPS, PiGDM,
PiGDM-videodiff, PengConvert, PengAnalytic, TMPD, DiffPIR) and the factory.

Each guided call runs on the tiny f32 UNet pair (``tests/_torch_parity.py``,
identical weights, learned-sigma output) with the same x_t, y and sigma in
both packages: the mechanisms carry no state but the call count and the
last solve's record, so every call is compared on its own. sigma 0.5 and
0.1 lie on either side of ``mle_sigma_thres`` = 0.2. x0 is held to rtol
1e-4 / atol 5e-4 with equal CG ``niter``. The JAX side runs eagerly around
a jitted denoiser (one compilation serves every call), its solvers on the
CPU's ``cg_coords='auto'`` (Fourier), as the port's.

The learned variance is teacher-forced: the port's denoiser returns its own
x0 and the JAX package's x0_var. Both compute x0_var = (v - pv) / pm1^2,
whose cancellation turns the UNets' 1e-7 rounding differences in v into
up to 1.3e-3 relative in x0_var at random weights; PengConvert's
inpainting solve at sigma 0.1 passed that on to x0 at 6.9e-4 (4.8e-7 for
every other call). The mechanism is what these tests compare."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.guidance import mechanisms as jmech
from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu.operators import get_operator as jget
from free_hunch_tpu_torch.guidance import mechanisms as tmech
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
from free_hunch_tpu_torch.models.unet import UNetConfig, UNetModel
from free_hunch_tpu_torch.operators import get_operator as tget
from free_hunch_tpu_torch.samplers import edm as tedm
from tests._torch_parity import one_thread, tiny_cfg_kwargs, tiny_pair  # noqa: F401

F32 = np.float32
RES = 32
B = 2
SHAPE = (B, 3, RES, RES)
STATELESS = ["dps", "pigdm", "pigdm_videodiff_schedule", "peng_convert", "peng_analytic",
             "tmpd", "diffpir"]


@pytest.fixture(scope="module")
def denoisers():
    """(JAX denoiser, port denoiser, port denoiser on the remat UNet)."""
    jm, params, tm = tiny_pair()
    pj = JPrecond(jm, img_resolution=RES, img_channels=3)
    remat = UNetModel(UNetConfig(**tiny_cfg_kwargs(), dtype=torch.float32, remat=True))
    remat.load_state_dict(tm.state_dict())
    remat.eval().requires_grad_(False)
    return (jax.jit(lambda x, s: pj.apply(params, x, s)),
            TPrecond(tm, img_resolution=RES, img_channels=3),
            TPrecond(remat, img_resolution=RES, img_channels=3))


def _operators(name):
    kw = dict(in_shape=(1, 3, RES, RES), sigma_s=0.1)
    if name == "inpainting":
        m = np.random.default_rng(11).uniform(size=(1, 1, RES, RES)) > 0.2
        kw["mask"] = np.repeat(m.astype(F32), 3, axis=1)
    return jget(name, **kw), tget(name, device="cpu", **kw)


def _call(denoisers, mech, op, sigma, remat=False, seed=0, **kw):
    """One guided call in both packages: (JAX x0, JAX state, port x0, port state)."""
    jden, tden, tden_remat = denoisers
    jo, to = _operators(op)
    rng = np.random.default_rng(seed)
    y = np.asarray(jo.forward(jnp.asarray(rng.uniform(-1, 1, SHAPE).astype(F32)),
                              noiseless=True))
    x = (rng.normal(size=SHAPE) * sigma).astype(F32)
    J = jmech.choose_conditioning_mechanism(mech)(cond_scaling=1.0, forward_operator=jo, **kw)
    T = tmech.choose_conditioning_mechanism(mech)(cond_scaling=1.0, forward_operator=to, **kw)
    jx, js = J(jden, jnp.asarray(x), jnp.asarray(y), jnp.float32(sigma),
               J.init_state(B, SHAPE[1:]))
    jvar = torch.as_tensor(np.asarray(jden(jnp.asarray(x), jnp.float32(sigma))[1]))
    net = tden_remat if remat else tden

    def forced(x_, s_):
        return net(x_, s_)[0], jvar

    tx, ts = T(forced, torch.as_tensor(x), torch.as_tensor(y), float(F32(sigma)),
               T.init_state(B, SHAPE[1:]))
    return np.asarray(jx), js, tx, ts


def _check(jx, js, tx, ts):
    assert tx.shape == SHAPE and torch.isfinite(tx).all()
    np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-4, atol=5e-4)
    assert ts.step == int(js.step) == 1
    assert ts.cg_niter == int(js.cg_niter)
    assert (ts.cg_host_syncs > 0) == (ts.cg_niter > 0)
    np.testing.assert_allclose(float(ts.cg_optfrac), float(js.cg_optfrac))


@pytest.mark.parametrize("sigma", [0.5, 0.1])
@pytest.mark.parametrize("op", ["gaussian_blur", "super_resolution", "inpainting"])
@pytest.mark.parametrize("mech", STATELESS)
def test_stateless_mechanism_call_matches_jax(denoisers, mech, op, sigma):
    _check(*_call(denoisers, mech, op, sigma))


@pytest.mark.parametrize("op", ["colorization", "noise", "phase_retrieval"])
def test_dps_on_the_other_operators_matches_jax(denoisers, op):
    """DPS needs only the operator's forward: colorization, denoising and
    the nonlinear phase retrieval (its gradient through |FFT|)."""
    _check(*_call(denoisers, "dps", op, 0.5))


@pytest.mark.parametrize("op", ["gaussian_blur", "super_resolution", "inpainting"])
def test_tmpd_on_the_remat_unet_matches_jax(denoisers, op):
    """TMPD pulls back twice through one forward (the variance probe, then
    ``mat``); under non-reentrant checkpointing the first pullback keeps
    the graph for the second."""
    _check(*_call(denoisers, "tmpd", op, 0.5, remat=True))


def test_posthoc_scaling_and_clip_match_jax(denoisers):
    _check(*_call(denoisers, "pigdm", "super_resolution", 0.5, pigdm_posthoc_scaling=True,
                  clip_x0_mean=True))


def test_factory_table_and_errors():
    want = {"dps": tmech.DPS, "pigdm": tmech.PiGDM,
            "pigdm_videodiff_schedule": tmech.PiGDMVideodiffSchedule,
            "online_covariance": tmech.FreeHunch, "peng_convert": tmech.PengConvert,
            "peng_analytic": tmech.PengAnalytic, "tmpd": tmech.TMPD, "diffpir": tmech.DiffPIR}
    for name, cls in want.items():
        assert tmech.choose_conditioning_mechanism(name) is cls
        assert jmech.choose_conditioning_mechanism(name).__name__ == cls.__name__
    with pytest.raises(ValueError, match="DDNM"):
        tmech.choose_conditioning_mechanism("ddnm")
    with pytest.raises(ValueError, match="Unknown conditioning mechanism"):
        tmech.choose_conditioning_mechanism("score_sde")


@pytest.mark.parametrize("mech", STATELESS)
def test_sample_loop_runs_every_mechanism(denoisers, mech):
    """Three Heun steps of the port's loop: a finite trajectory and the CG
    diagnostics of every guided call (0 iterations for closed forms and
    DPS, whose record stays at its start)."""
    _, tden, _ = denoisers
    _, to = _operators("super_resolution")
    xs, s0 = tedm.prepare_schedule(round_sigma=tden.round_sigma, net_sigma_min=tden.sigma_min,
                                   net_sigma_max=tden.sigma_max, num_steps=3)
    rng = np.random.default_rng(2)
    y = to.forward(torch.as_tensor(rng.uniform(-1, 1, SHAPE).astype(F32)), noiseless=True)
    T = tmech.choose_conditioning_mechanism(mech)(cond_scaling=1.0, forward_operator=to)
    x, traj, diag = tedm.sample_loop(tden, T, torch.as_tensor(rng.normal(size=SHAPE).astype(F32)),
                                     y, xs, sigma0_scaled=s0, return_trajectory=True,
                                     collect_diagnostics=True)
    assert traj.shape == (3,) + SHAPE and torch.isfinite(traj).all() and torch.equal(x, traj[-1])
    n = diag["cg_niter"].numpy()
    assert n.shape == (3, 2) and n[-1, 1] == -1
    assert diag["host_syncs"] >= 0 and ((n[:, 0] > 0).any() == (diag["host_syncs"] > 0))
