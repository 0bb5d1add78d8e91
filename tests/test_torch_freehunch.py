"""Port parity for Free Hunch guidance and the EDM sampler.

* Teacher-forced per call: before every guidance call the torch mechanism
  gets the JAX mechanism's state, so each call is compared on its own.
  The sigmas cover the time-update regime (sigma > 10) and the BFGS window
  (1 < sigma < 10); the denoiser is a cheap nonlinear function written in
  both frameworks, so the mechanism itself is what is compared.
* The whole slice: 3 Heun steps at 32 px through the tiny UNet against
  ``sample_scan``, with S_churn = 0 and the same initial noise.

Both run ``cg_coords='pixel'``, the card's solver ('auto' picks the
Fourier-coordinate one on the CPU; tests/test_torch_solvers.py holds it).
The helpers take the operator, so tests/test_torch_freehunch_ops.py runs
the same comparisons on super-resolution and inpainting."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.guidance import mechanisms as jmech
from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu.operators import get_operator as jget_operator
from free_hunch_tpu.ops import lowrank as jlr
from free_hunch_tpu.samplers import edm as jedm
from free_hunch_tpu_torch.guidance import mechanisms as tmech
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
from free_hunch_tpu_torch.operators import get_operator as tget_operator
from free_hunch_tpu_torch.ops import lowrank as tlr
from free_hunch_tpu_torch.samplers import edm as tedm
from tests._torch_parity import one_thread, tiny_pair  # noqa: F401

F32 = np.float32
RES = 32
B = 2
SHAPE = (B, 3, RES, RES)


def _operators(sigma_s=0.1, name="gaussian_blur"):
    """The blur is the shipped 61x61 gaussian kernel, centre-cropped to the
    32 px grid; super-resolution is x4; inpainting gets one explicit mask."""
    kw = dict(in_shape=(1, 3, RES, RES), sigma_s=sigma_s)
    if name == "inpainting":
        m = np.random.default_rng(11).uniform(size=(1, 1, RES, RES)) > 0.2
        kw["mask"] = np.repeat(m.astype(F32), 3, axis=1)
    return jget_operator(name=name, **kw), tget_operator(name=name, device="cpu", **kw)


@pytest.fixture(scope="module")
def prior_dir(tmp_path_factory):
    """A DCT variance prior matched to the 32 px grid: the 32 lowest
    frequencies of the bundled 256 px prior, scaled by (32/256)^2 (an
    orthonormal DCT coefficient's variance grows with the side squared).
    The bundled prior truncated with ``reshape(-1)[:d]`` (what both packages
    do at other resolutions, checked in test_init_diag_truncation_equals_jax)
    puts the first rows of the 256 px red channel on the 32 px grid; its CG
    systems are then ill-conditioned enough that f32 rounding alone moves
    the stopped iterates by ~1e-3, which would hide real differences."""
    from free_hunch_tpu.operators import assets as jassets
    d = tmp_path_factory.mktemp("prior32")
    p = jassets.dct_variance()[:, :RES, :RES] / (256 // RES) ** 2
    np.savez(d / "dct_variance.npz", dct_variance=p.astype(F32))
    return str(d)


def _mechs(data_dir=None, op="gaussian_blur", **kw):
    jop, top = _operators(name=op)
    base = dict(cond_scaling=1.0, image_base_covariance="dct_diagonal",
                data_dir=data_dir,
                init_denoiser_variance=1.0, init_noise_variance=80.0**2,
                data_dim=3 * RES * RES, cov_capacity=8, solver_type="customcuda",
                cg_coords="pixel")
    base.update(kw)
    return (jmech.FreeHunch(forward_operator=jop, **base),
            tmech.FreeHunch(forward_operator=top, **base))


_W = np.random.default_rng(42).normal(size=(1,) + SHAPE[1:]).astype(F32) * 0.3


def _jdenoise(x, sigma):
    a = 1.0 / jnp.sqrt(1.0 + sigma**2)
    x0 = jnp.tanh(x * a + jnp.asarray(_W))
    return x0, jnp.broadcast_to(sigma**2 / (1 + sigma**2), x.shape)


def _tdenoise(x, sigma):
    a = 1.0 / np.sqrt(np.float32(1.0) + np.float32(sigma) ** 2)
    x0 = torch.tanh(x * float(a) + torch.as_tensor(_W))
    return x0, torch.full_like(x, sigma**2 / (1 + sigma**2))


def _to_torch_state(js):
    c = js.cov
    t = lambda a: torch.as_tensor(np.array(a, F32))  # noqa: E731
    return tmech.FreeHunchState(
        cov=tlr.LowRank(diag=t(c.diag), Ut=t(c.Ut), M=t(c.M),
                        k=torch.as_tensor(np.array(c.k), dtype=torch.int64)),
        prev_sigma=float(np.asarray(js.prev_sigma)), prev_x=t(js.prev_x),
        prev_mean=t(js.prev_mean), prev_u=t(js.prev_u), step=int(js.step),
        cg_niter=int(js.cg_niter), cg_resnorm=t(js.cg_resnorm),
        cg_optfrac=t(js.cg_optfrac), cg_host_syncs=0)


def _cov_probe_close(tcov, jcov, rtol):
    """Compare covariance states through their action on probe vectors
    (d = 3072: dense matrices would be needlessly large)."""
    probe = np.random.default_rng(7).normal(size=(B, tcov.diag.shape[-1])).astype(F32)
    want = np.asarray(jax.vmap(jlr.matvec)(jcov, jnp.asarray(probe)))
    got = tlr.matvec(tcov, torch.as_tensor(probe)).numpy()
    np.testing.assert_array_equal(tcov.k.numpy(), np.asarray(jcov.k))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# sigma sequence: time updates at sigma > 10, then repeated sigmas inside the
# window (x changed at equal sigma -> BFGS pair), then low sigma
SIGMAS = [40.0, 14.0, 14.0, 6.0, 6.0, 2.5, 2.5, 1.2, 0.4]


def _teacher_forced(prior_dir, op="gaussian_blur", sigmas=SIGMAS, full_rank=True, **mech_kw):
    """Each guided call of ``sigmas`` in both packages, the port's state
    taken from the JAX package's before every call; x0, the covariance, the
    recycled u and the CG count compared after it."""
    jm, tm = _mechs(prior_dir, op=op, **mech_kw)
    rng = np.random.default_rng(0)
    y = rng.uniform(-1, 1, (B,) + tuple(tm.forward_operator.out_shape[1:])).astype(F32)
    js = jm.init_state(B, SHAPE[1:])
    step = jax.jit(lambda x, s, st: jm.x0_mean_update(_jdenoise, x, jnp.asarray(y), s, st))
    x = rng.normal(size=SHAPE).astype(F32) * sigmas[0]
    ranks = []
    for i, sigma in enumerate(sigmas):
        s = float(F32(sigma))
        if i and sigmas[i - 1] == sigma:     # second call at one sigma: move x
            x = x + rng.normal(size=SHAPE).astype(F32) * 0.05 * s
        elif i:
            x = rng.normal(size=SHAPE).astype(F32) * s
        ts = _to_torch_state(js)
        jx0, js = step(jnp.asarray(x), jnp.float32(s), js)
        tx0, ts = tm.x0_mean_update(_tdenoise, torch.as_tensor(x), torch.as_tensor(y), s, ts)
        # Tolerances (x0 is O(1)): each solve stops at its rtol along two f32
        # rounding paths (observed <= 1e-4); the capacity-8 state fills at
        # call 6 and call 7 compresses it (Cholesky of the Gram matrix of
        # nearly collinear BFGS columns, then eigh), which amplifies f32
        # rounding to ~1e-4 of the state and ~2e-4 of x0.
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-4, atol=5e-4,
                                   err_msg=f"call {i} sigma {s}")
        _cov_probe_close(ts.cov, js.cov, rtol=1e-3)
        ju = np.asarray(js.prev_u)
        np.testing.assert_allclose(ts.prev_u.numpy(), ju, rtol=1e-4,
                                   atol=1e-4 * np.abs(ju).max())
        assert ts.cg_niter == int(js.cg_niter), (i, ts.cg_niter, int(js.cg_niter))
        ranks.append(int(np.asarray(js.cov.k).max()))
    if full_rank:
        assert max(ranks) == 8, "the BFGS window must fill the capacity (compress)"


@pytest.mark.parametrize("grad,warm,fb_threshold", [
    ("vjp", "b", 0.2), ("vjp", "prev", 1e9), ("covariance", "prev", 0.2),
    ("hybrid", "prev", 1e9)])
def test_x0_mean_update_teacher_forced_matches_jax(grad, warm, fb_threshold, prior_dir):
    """fb_threshold=1e9 keeps the vjp gradient (the toy denoiser's updates
    would otherwise trip the large-update fallback at every call)."""
    _teacher_forced(prior_dir, guidance_gradient=grad, cg_warm_start=warm,
                    guidance_vjp_below=2.0, denoiser_mean_error_threshold=fb_threshold)


def test_schedule_and_capacity_equal_jax():
    pre_j = JPrecond(None, img_resolution=RES, img_channels=3)
    pre_t = TPrecond(torch.nn.Identity(), img_resolution=RES, img_channels=3)
    for kw in (dict(num_steps=30), dict(num_steps=3), dict(num_steps=7, solver="euler"),
               dict(num_steps=10, discretization="iddpm", S_churn=5.0)):
        xj, s0j = jedm.prepare_schedule(round_sigma=pre_j.round_sigma,
                                        net_sigma_min=pre_j.sigma_min,
                                        net_sigma_max=pre_j.sigma_max, **kw)
        xt, s0t = tedm.prepare_schedule(round_sigma=pre_t.round_sigma,
                                        net_sigma_min=pre_t.sigma_min,
                                        net_sigma_max=pre_t.sigma_max, **kw)
        assert s0j == s0t
        assert xj.keys() == xt.keys()
        for k in xj:
            np.testing.assert_array_equal(xt[k], xj[k])
        assert tedm.required_cov_capacity(xt) == jedm.required_cov_capacity(xj)


def test_init_diag_truncation_equals_jax():
    """At 32 px both packages take the first d entries of the flattened
    256 px prior (mechanisms.py:421)."""
    jm, tm = _mechs()
    want = np.asarray(jm._init_diag(SHAPE[1:]))
    got = tm._init_diag(SHAPE[1:], "cpu").numpy()
    np.testing.assert_array_equal(got, want.astype(F32))
    ts = tm.init_state(B, SHAPE[1:])
    np.testing.assert_array_equal(ts.cov.diag.numpy(), np.broadcast_to(want, (B, want.size)))
    assert ts.prev_u.shape == SHAPE and ts.cov.Ut.shape == (B, 8, want.size)


def _run_slice(prior_dir, solver, op="gaussian_blur", **mech_kw):
    """The whole slice at 32 px in both packages: tiny UNet (same weights),
    dct_diagonal Free Hunch with vjp guidance and recycled CG starts, three
    steps of ``solver``. Returns the JAX and the torch trajectories, each
    step's max |x| in the JAX one, and the CG ``niter`` diagnostics."""
    jm_net, params, tm_net = tiny_pair()
    pre_j = JPrecond(jm_net, img_resolution=RES, img_channels=3)
    pre_t = TPrecond(tm_net, img_resolution=RES, img_channels=3)
    kw = dict(round_sigma=pre_j.round_sigma, net_sigma_min=pre_j.sigma_min,
              net_sigma_max=pre_j.sigma_max, num_steps=3, solver=solver,
              discretization="edm", schedule="linear", scaling="none")
    xs, s0 = jedm.prepare_schedule(**kw)
    cap = jedm.required_cov_capacity(xs)
    jm, tm = _mechs(prior_dir, op=op, **dict(dict(cov_capacity=cap, cg_warm_start="prev",
                                                  guidance_gradient="vjp"), **mech_kw))
    rng = np.random.default_rng(1)
    noise = rng.normal(size=SHAPE).astype(F32)
    y = rng.uniform(-1, 1, (B,) + tuple(tm.forward_operator.out_shape[1:])).astype(F32)

    @jax.jit
    def run(noise_, y_):
        den = lambda x, s: pre_j.apply(params, x, s)  # noqa: E731
        return jedm.sample_scan(den, jm, noise_, y_, xs, jax.random.PRNGKey(0),
                                sigma0_scaled=s0, return_trajectory=True,
                                collect_diagnostics=True)

    jx, jtraj, jdiag = run(jnp.asarray(noise), jnp.asarray(y))
    tx, ttraj, tdiag = tedm.sample_loop(pre_t, tm, torch.as_tensor(noise),
                                        torch.as_tensor(y), xs, sigma0_scaled=s0,
                                        return_trajectory=True, collect_diagnostics=True)
    assert torch.isfinite(tx).all() and torch.equal(tx, ttraj[-1])
    assert tdiag["host_syncs"] > 0
    jtraj = np.asarray(jtraj)
    scale = np.abs(jtraj).reshape(3, -1).max(axis=1)
    jn, tn = np.asarray(jdiag["cg_niter"]), tdiag["cg_niter"].numpy()
    assert tn.shape == jn.shape == (3, 2)
    np.testing.assert_array_equal(tn[:, 1] == -1, jn[:, 1] == -1)
    np.testing.assert_array_equal(tn, jn)
    return jtraj, ttraj.numpy(), scale


def test_sampler_slice_three_heun_steps_matches_sample_scan(prior_dir):
    """3 Heun steps (sigma 80 -> 3.46 -> 0.002 -> 0), the bench's solver.
    Each guided call differs by ~1e-4 of its scale between the packages (CG
    stopped at rtol along two f32 paths). Steps 0 and 1 are held to 3e-4
    of their own max |x| (observed 5.1e-5 and 9.9e-5 of 16.5 and 294). The
    random weights leave x at |x| ~ 294 at sigma 0.002, and the last Euler
    step maps x to the clipped denoiser output, which keeps x's error in
    [-1, 1]: it is held to 3e-4 of its input's max |x| (observed 0.019
    against 0.088). The Euler test below holds a last step tightly."""
    jtraj, ttraj, scale = _run_slice(prior_dir, "heun")
    for i, lim in enumerate([3e-4 * scale[0], 3e-4 * scale[1], 3e-4 * scale[1]]):
        np.testing.assert_allclose(ttraj[i], jtraj[i], rtol=0, atol=lim,
                                   err_msg=f"step {i}")


def test_sampler_slice_three_euler_steps_matches_sample_scan(prior_dir):
    """3 Euler steps: x stays within |x| <= 15, so every step, the last
    included, is held to 2e-4 of its own max |x| (observed 4.8e-6, 1.7e-5
    and 4.3e-5; the last step's output has max |x| 1.0, about half of it
    unsaturated by the denoiser's clip)."""
    jtraj, ttraj, scale = _run_slice(prior_dir, "euler")
    for i in range(3):
        np.testing.assert_allclose(ttraj[i], jtraj[i], rtol=0, atol=2e-4 * scale[i],
                                   err_msg=f"step {i}")


def test_conditional_sampler_matches_jax(prior_dir):
    """The one-shot entry point (schedule, measurement, loop) against the
    JAX package's ``conditional_sampler`` with the same injected noise:
    3 Euler steps, no churn, and a noiseless operator (sigma_s 0), so the
    two packages' measurement draws, which cannot agree, add nothing. y
    is the blur through two FFT libraries, held to 1e-6 of its max |y|
    (observed 3e-8 on values up to 0.14). The solves run at the clipped
    sigma_s 0.001, sharper than at 0.1, and the first step's difference
    (2.8e-4 of max |x| 13.7) is carried through the later steps, whose |x|
    shrinks to 1.1: every step is held to 1e-4 of the first step's max |x|
    (observed 2.1e-5)."""
    jm_net, params, tm_net = tiny_pair()
    pre_j = JPrecond(jm_net, img_resolution=RES, img_channels=3)
    pre_t = TPrecond(tm_net, img_resolution=RES, img_channels=3)
    kw = dict(num_steps=3, solver="euler", discretization="edm", schedule="linear",
              scaling="none", return_trajectory=True)
    xs, _ = jedm.prepare_schedule(round_sigma=pre_j.round_sigma, net_sigma_min=pre_j.sigma_min,
                                  net_sigma_max=pre_j.sigma_max, num_steps=3, solver="euler")
    jop, top = _operators(sigma_s=0.0)
    base = dict(cond_scaling=1.0, image_base_covariance="dct_diagonal", data_dir=prior_dir,
                init_denoiser_variance=1.0, init_noise_variance=80.0**2,
                data_dim=3 * RES * RES, cov_capacity=jedm.required_cov_capacity(xs),
                solver_type="customcuda", cg_coords="pixel", cg_warm_start="prev")
    rng = np.random.default_rng(2)
    noise = rng.normal(size=SHAPE).astype(F32)
    cond = rng.uniform(-1, 1, SHAPE).astype(F32)
    jx, jtraj, jy = jedm.conditional_sampler(
        lambda x, s: pre_j.apply(params, x, s), jnp.asarray(noise), jnp.asarray(cond), jop,
        jmech.FreeHunch(forward_operator=jop, **base), rng_key=jax.random.PRNGKey(0),
        round_sigma=pre_j.round_sigma, net_sigma_min=pre_j.sigma_min,
        net_sigma_max=pre_j.sigma_max, **kw)
    tx, ttraj, ty = tedm.conditional_sampler(
        pre_t, torch.as_tensor(noise), torch.as_tensor(cond), top,
        tmech.FreeHunch(forward_operator=top, **base), round_sigma=pre_t.round_sigma,
        net_sigma_min=pre_t.sigma_min, net_sigma_max=pre_t.sigma_max,
        generator=torch.Generator().manual_seed(0), **kw)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-6 * np.abs(jy).max())
    jtraj = np.asarray(jtraj)
    assert ttraj.shape == jtraj.shape == (3,) + SHAPE and torch.equal(tx, ttraj[-1])
    lim = 1e-4 * np.abs(jtraj[0]).max()
    for i in range(3):
        np.testing.assert_allclose(ttraj[i].numpy(), jtraj[i], rtol=0, atol=lim,
                                   err_msg=f"step {i}")
