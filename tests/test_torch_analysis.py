"""Port parity for the exact-posterior oracles (``analysis/``): the GMM's
analytic quantities in float64, the linear-Gaussian pieces, and both
samplers run on the same numpy draws through the JAX package's pieces
(``FreeHunch``, ``prepare_schedule``, ``sample_scan``) and through the
port's step functions, in both guidance-gradient modes. The n = 256 and
n = 1024 moment checks against the exact posteriors run on the card
(``chip_smoke.py`` phase 8) and in tests/test_torch_chip_smoke_oracle.py
at a CPU size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.analysis import gmm as JG
from free_hunch_tpu.analysis import gmm_guided as jgg
from free_hunch_tpu.analysis import linear_gaussian as jlg
from free_hunch_tpu.guidance import mechanisms as jmech
from free_hunch_tpu.operators import get_operator as jget_operator
from free_hunch_tpu.ops import lowrank as jlr
from free_hunch_tpu.samplers import edm as jedm
from free_hunch_tpu_torch.analysis import gmm as TG
from free_hunch_tpu_torch.analysis import gmm_guided as tgg
from free_hunch_tpu_torch.analysis import linear_gaussian as tlg
from free_hunch_tpu_torch.ops import lowrank as tlr
from tests._torch_parity import one_thread  # noqa: F401

F32 = np.float32
OPERATOR = dict(name="gaussian_blur", kernel_size=9, intensity=1.5)
SIGMA_Y = 0.1


def _mixture(seed=0, k=3, d=2):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(k, d)) * 2
    covs = []
    for _ in range(k):
        a = rng.normal(size=(d, d))
        covs.append(a @ a.T + 0.3 * np.eye(d))
    w = rng.uniform(0.2, 1.0, k)
    return w / w.sum(), means, np.stack(covs)


def _pair(seed=0, k=3, d=2):
    w, m, c = _mixture(seed, k, d)
    return (JG.GaussianMixture(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c)),
            TG.GaussianMixture(torch.as_tensor(w), torch.as_tensor(m), torch.as_tensor(c)))


@pytest.mark.parametrize("d", [2, 3])
def test_gmm_analytic_quantities_match_jax_in_float64(d):
    """log_prob, responsibilities, score, its Hessian, the denoiser mean
    and covariance at two sigmas, batch (5, d): within 1e-10 relative of
    the JAX package's (x64; both f64 LAPACK on the CPU)."""
    jg, tg = _pair(d, d=d)
    x = np.random.default_rng(9).normal(size=(5, d)) * 2
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    for sigma in (0.3, 4.0):
        pairs = [(tg.at_noise_level(sigma).log_prob(xt), jg.at_noise_level(sigma).log_prob(xj)),
                 (tg.at_noise_level(sigma).responsibilities(xt),
                  jg.at_noise_level(sigma).responsibilities(xj)),
                 (TG.score(tg, xt, sigma), JG.score(jg, xj, sigma)),
                 (TG.score_hessian(tg, xt, sigma), JG.score_hessian(jg, xj, sigma)),
                 (TG.denoiser_mean(tg, xt, sigma), JG.denoiser_mean(jg, xj, sigma)),
                 (TG.denoiser_covariance(tg, xt, sigma), JG.denoiser_covariance(jg, xj, sigma))]
        for got, want in pairs:
            assert got.dtype == torch.float64
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max())


def test_gmm_score_is_the_gradient_of_log_prob():
    """The port's own autograd of log p_sigma against its closed forms."""
    _, tg = _pair(1)
    x = torch.tensor([[0.3, -0.7]], dtype=torch.float64, requires_grad=True)
    lp = tg.at_noise_level(0.8).log_prob(x).sum()
    (g,) = torch.autograd.grad(lp, x)
    np.testing.assert_allclose(TG.score(tg, x.detach(), 0.8).numpy(), g.numpy(), rtol=1e-10)
    h = torch.autograd.functional.hessian(
        lambda z: tg.at_noise_level(0.8).log_prob(z[None])[0], x.detach()[0])
    np.testing.assert_allclose(TG.score_hessian(tg, x.detach(), 0.8)[0].numpy(), h.numpy(),
                               rtol=1e-8, atol=1e-12)


def test_gmm_posterior_given_y_matches_jax():
    """Weights, means and covariances of the exact posterior within 1e-10."""
    jg, tg = _pair(4, d=3)
    A = np.random.default_rng(5).normal(size=(2, 3))
    y = np.array([0.5, -1.0])
    jp = JG.posterior_given_y(jg, jnp.asarray(A), jnp.asarray(y), 0.4)
    tp = TG.posterior_given_y(tg, A, y, 0.4)
    for got, want in ((tp.weights, jp.weights), (tp.means, jp.means), (tp.covs, jp.covs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_gmm_sample_and_ode_reach_the_mixture_moments():
    """Draws differ from the JAX package's (another generator), so the
    samplers are held to the mixture: the mean of 4000 direct samples and
    of 2000 probability-flow ODE samples (50 Heun steps, exact score)
    within 0.15 of the mixture mean."""
    _, tg = _pair(2)
    mean = (tg.weights[:, None] * tg.means).sum(0).numpy()
    gen = torch.Generator().manual_seed(0)
    s = tg.sample(gen, (4000,))
    assert s.shape == (4000, 2)
    np.testing.assert_allclose(s.mean(0).numpy(), mean, atol=0.15)
    x = TG.sample_ode(tg, 2000, gen, num_steps=50)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.mean(0).numpy(), mean, atol=0.15)
    den = TG.guided_denoiser_fn(tg)
    m, v = den(x[:3].float(), 2.0)
    assert m.dtype == torch.float32 and torch.allclose(v, torch.full_like(v, 0.8))


def test_linear_gaussian_pieces_match_jax():
    """The spectrum bitwise; A (the blur of every basis image) and B (the
    inverse DCT) within 1e-6 (f32 on both sides, returned as f64); the
    exact posterior (host f64 on both sides) within 1e-10; the denoiser
    within 1e-6."""
    shape = (3, 8, 8)
    v = tlg.make_smooth_spectrum(shape, decades=4.0, v_max=30.0)
    np.testing.assert_array_equal(v, jlg.make_smooth_spectrum(shape, decades=4.0, v_max=30.0))
    jop = jget_operator(in_shape=(1,) + shape, sigma_s=SIGMA_Y, **OPERATOR)
    top = tlg.linear_gaussian_operator(shape, OPERATOR, SIGMA_Y, "cpu")
    A, jA = tlg.dense_operator_matrix(top, shape), jlg.dense_operator_matrix(jop, shape)
    B, jB = tlg.idct_basis_matrix(shape, "cpu"), jlg.idct_basis_matrix(shape)
    assert A.dtype == B.dtype == np.float64 and A.shape == B.shape == (192, 192)
    np.testing.assert_allclose(A, jA, atol=1e-6)
    np.testing.assert_allclose(B, jB, atol=1e-6)
    y = np.random.default_rng(0).normal(size=192)
    for got, want in zip(tlg.exact_posterior(A, B, v, y, SIGMA_Y),
                         jlg.exact_posterior(jA, jB, v, y, SIGMA_Y)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8 * np.abs(want).max())
    x = np.random.default_rng(1).normal(size=(2,) + shape).astype(F32)
    tm, tv = tlg.dct_gaussian_denoiser(torch.as_tensor(v, dtype=torch.float32))(
        torch.as_tensor(x), 2.5)
    jm, jv = jlg.dct_gaussian_denoiser(jnp.asarray(v, jnp.float32))(jnp.asarray(x),
                                                                    jnp.float32(2.5))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


# the sampler step at a small size: (3, 16, 16), n = 4, 6 Heun steps
STEP_SHAPE = (3, 16, 16)
STEP_N = 4
STEP_STEPS = 6


def _jax_linear_gaussian(v, noise, y, tmp, **mech_kw):
    """The JAX pieces of ``sample_linear_gaussian_posterior`` on explicit
    inputs (``free_hunch_tpu/analysis/linear_gaussian.py:114-150``)."""
    np.savez(tmp / "dct_variance.npz", dct_variance=v.astype(F32))
    op = jget_operator(in_shape=(1,) + STEP_SHAPE, sigma_s=SIGMA_Y, **OPERATOR)
    mkw = dict(cond_scaling=1.0, clip_x0_mean=False, image_base_covariance="dct_diagonal",
               data_dir=str(tmp), init_denoiser_variance=1.0, init_noise_variance=80.0**2,
               data_dim=int(np.prod(STEP_SHAPE)), cov_capacity=16, max_rtol=1e-5,
               cg_maxiter=200, solver_type="customcuda", **mech_kw)
    mech = jmech.FreeHunch(forward_operator=op, **mkw)
    xs, s0 = jedm.prepare_schedule(
        round_sigma=lambda s, return_index=False: s, net_sigma_min=2e-3, net_sigma_max=80.0,
        num_steps=STEP_STEPS, solver="heun", discretization="edm", schedule="linear",
        scaling="none", sigma_min=2e-3, sigma_max=80.0)
    den = jlg.dct_gaussian_denoiser(jnp.asarray(v, jnp.float32))
    y_b = jnp.broadcast_to(jnp.asarray(y), (STEP_N,) + y.shape[1:])
    x, traj, diag = jax.jit(lambda nz, yv: jedm.sample_scan(
        den, mech, nz, yv, xs, jax.random.PRNGKey(0), sigma0_scaled=s0,
        return_trajectory=True, collect_diagnostics=True))(jnp.asarray(noise), y_b)
    return np.asarray(x), np.asarray(diag["cg_niter"])


@pytest.mark.parametrize("mode", ["vjp", "covariance"])
def test_linear_gaussian_sampler_step_matches_the_jax_pieces(mode, tmp_path):
    """The same noise and y through both: equal CG iterations at every
    stage, and the samples within 1e-4 of their max |x| (observed 3.9e-6
    in both modes: each of the 11 guided calls' CG stops at rtol along two
    f32 summation orders). Both run the card's pixel-space CG
    (``cg_coords='pixel'``)."""
    v = tlg.make_smooth_spectrum(STEP_SHAPE)
    op = tlg.linear_gaussian_operator(STEP_SHAPE, OPERATOR, SIGMA_Y, "cpu")
    noise, y, _ = tlg.draw_linear_gaussian_inputs(v, op, STEP_N,
                                                  torch.Generator().manual_seed(3))
    kw = dict(guidance_gradient=mode, cg_coords="pixel")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jx, jn = _jax_linear_gaussian(v, noise.numpy(), y.numpy(), tmp_path / "j", **kw)
    tx, diag = tlg.sample_linear_gaussian_posterior_from(
        v, noise, y, op, data_dir=str(tmp_path / "t"), num_steps=STEP_STEPS,
        mechanism_kwargs=kw)
    np.testing.assert_array_equal(diag["cg_niter"].numpy(), jn)
    print(mode, np.abs(tx.numpy() - jx).max() / np.abs(jx).max())
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())


def test_linear_gaussian_wrapper_draws_and_returns_the_jax_contract(tmp_path):
    """The wrapper returns ``(samples (n, d), y (m,), op, x_true (d,))`` as
    the JAX function does, and ``sample_loop``'s diagnostics after them,
    the same as its two pieces from one generator."""
    v = tlg.make_smooth_spectrum(STEP_SHAPE)
    s, y, op, xt, diag = tlg.sample_linear_gaussian_posterior(
        v, img_shape=STEP_SHAPE, operator_kwargs=OPERATOR, sigma_y=SIGMA_Y,
        data_dir=str(tmp_path), n=2, num_steps=3, generator=torch.Generator().manual_seed(1),
        device="cpu")
    d = int(np.prod(STEP_SHAPE))
    assert s.shape == (2, d) and y.shape == (d,) and xt.shape == (d,)
    noise, y2, xt2 = tlg.draw_linear_gaussian_inputs(v, op, 2, torch.Generator().manual_seed(1))
    x2, diag2 = tlg.sample_linear_gaussian_posterior_from(v, noise, y2, op,
                                                          data_dir=str(tmp_path), num_steps=3)
    np.testing.assert_array_equal(s, x2.reshape(2, -1).numpy())
    np.testing.assert_array_equal(diag["cg_niter"].numpy(), diag2["cg_niter"].numpy())
    assert diag["cov_resets"] == diag2["cov_resets"] == 0
    np.testing.assert_array_equal(y, y2.reshape(-1).numpy())
    np.testing.assert_array_equal(xt, xt2.reshape(-1).numpy())


def _gmm_f32():
    """tests/test_gmm_guided.py's mixture, f32 arrays in both packages."""
    rng = np.random.default_rng(0)
    covs = []
    for _ in range(2):
        a = rng.normal(size=(2, 2)) * 0.5
        covs.append(a @ a.T + 0.4 * np.eye(2))
    w, m, c = (np.array([0.6, 0.4], F32), np.array([[2.0, 1.0], [-2.0, -1.0]], F32),
               np.stack(covs).astype(F32))
    return (JG.GaussianMixture(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c)),
            TG.GaussianMixture(torch.as_tensor(w), torch.as_tensor(m), torch.as_tensor(c)))


@pytest.mark.parametrize("mode", ["vjp", "covariance"])
def test_gmm_guided_sampler_step_matches_the_jax_pieces(mode):
    """8 samples, 12 Heun steps (the BFGS window's pairs fill the capacity
    16 state and compress it), the same noise through the JAX pieces of
    ``sample_gmm_posterior`` (``gmm_guided.py:55-82``) and the port's
    step: equal CG iterations and samples within 3e-3 of max |x| (observed
    3.9e-4 with vjp, 1.0e-3 with the covariance gradient: the JAX GMM
    works in f32, the port's in f64, and the compressed state carries the
    difference)."""
    jg, tg = _gmm_f32()
    mask, yv, n, steps = np.array([1.0, 0.0], F32), np.array([1.8, 0.0], F32), 8, 12
    noise = np.random.default_rng(4).normal(size=(n, 2, 1, 1)).astype(F32)
    kw = dict(guidance_gradient=mode)
    op = jget_operator(name="inpainting", sigma_s=0.3, mask=mask.reshape(1, 2, 1, 1),
                       in_shape=(1, 2, 1, 1))
    mkw = dict(cond_scaling=1.0, clip_x0_mean=False, init_denoiser_variance=1.0, data_dim=2,
               cov_capacity=16, image_base_covariance="identity",
               space_step_update_lower_threshold=1.0, space_step_update_threshold=10.0,
               denoiser_mean_error_threshold=1e9, max_rtol=1e-4, transport_mean_bound=10.0,
               guidance_update_bound=20.0, cg_maxiter=50, **kw)
    mech = jmech.FreeHunch(forward_operator=op, init_noise_variance=20.0**2, **mkw)
    xs, s0 = jedm.prepare_schedule(
        round_sigma=lambda s, return_index=False: s, net_sigma_min=1e-3, net_sigma_max=20.0,
        num_steps=steps, solver="heun", discretization="edm", schedule="linear",
        scaling="none", sigma_min=2e-3, sigma_max=20.0)
    y_img = jnp.asarray((mask * yv).reshape(1, 2, 1, 1) * np.ones((n, 1, 1, 1), F32))
    jx, _, jdiag = jax.jit(lambda nz, yy: jedm.sample_scan(
        jgg.gmm_image_denoiser(jg), mech, nz, yy, xs, jax.random.PRNGKey(0),
        sigma0_scaled=s0, collect_diagnostics=True))(jnp.asarray(noise), y_img)
    tx, tdiag = tgg.sample_gmm_posterior_from(tg, mask, yv, 0.3, torch.as_tensor(noise),
                                              num_steps=steps, mechanism_kwargs=kw)
    np.testing.assert_array_equal(tdiag["cg_niter"].numpy(), np.asarray(jdiag["cg_niter"]))
    jx = np.asarray(jx)
    print(mode, np.abs(tx.numpy() - jx).max() / np.abs(jx).max())
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=3e-3 * np.abs(jx).max())
    post = tgg.gmm_posterior(tg, mask, yv, 0.3)
    jpost = JG.posterior_given_y(JG.GaussianMixture(*(jnp.asarray(a, jnp.float64) for a in (
        jg.weights, jg.means, jg.covs))), jnp.eye(2)[:1], jnp.asarray([1.8]), 0.3)
    np.testing.assert_allclose(post.means.numpy(), np.asarray(jpost.means), rtol=1e-6)


def test_compress_of_a_rank_deficient_gram_keeps_no_column_as_jax():
    """A capacity-16 state whose columns span only d = 2 dimensions (the
    GMM's) has a Gram matrix that does not factor in f32: the JAX package's
    Cholesky returns NaN there and its compress keeps no column (k = 0,
    U = 0, M = I). The port's compress raised; it now gives the same."""
    rng = np.random.default_rng(0)
    cols = rng.normal(size=(16, 2)).astype(F32)
    cols /= np.linalg.norm(cols, axis=1, keepdims=True)
    M = np.diag(rng.uniform(0.5, 2.0, 16)).astype(F32)
    jrep = jlr.LowRank(diag=jnp.ones(2, jnp.float32), Ut=jnp.asarray(cols),
                       M=jnp.asarray(M), k=jnp.asarray(16, jnp.int32))
    jout = jlr.compress(jrep, 14)
    trep = tlr.LowRank(diag=torch.ones(2, 2), Ut=torch.as_tensor(cols)[None].repeat(2, 1, 1),
                       M=torch.as_tensor(M)[None].repeat(2, 1, 1),
                       k=torch.tensor([16, 16]))
    # the second row keeps two columns: a state that does factor is unchanged
    trep = trep._replace(Ut=torch.cat([trep.Ut[:1], torch.zeros(1, 16, 2)]))
    trep.Ut[1, 0, 0] = trep.Ut[1, 1, 1] = 1.0
    tout = tlr.compress(trep, 14)
    assert int(jout.k) == 0 and tout.k.tolist() == [0, 2]
    np.testing.assert_array_equal(tout.Ut[0].numpy(), np.asarray(jout.Ut))
    np.testing.assert_array_equal(tout.M[0].numpy(), np.asarray(jout.M))
    assert torch.isfinite(tout.Ut).all() and torch.isfinite(tout.M).all()


def test_append_pair_counts_the_rows_its_compress_reset():
    """The reset is counted per row (``resets``, in place), and only where
    the row needed the compress."""
    rng = np.random.default_rng(0)
    cols = rng.normal(size=(16, 2)).astype(F32)
    cols /= np.linalg.norm(cols, axis=1, keepdims=True)
    Ut = torch.as_tensor(cols)[None].repeat(3, 1, 1)
    rep = tlr.LowRank(diag=torch.ones(3, 2), Ut=Ut, M=torch.eye(16).repeat(3, 1, 1),
                      k=torch.tensor([16, 16, 2]))
    a, b = torch.as_tensor(rng.normal(size=(2, 3, 2)).astype(F32))
    resets = torch.tensor([5, 0, 0])
    out = tlr.append_pair(rep, a, torch.ones(3), b, -torch.ones(3), resets=resets)
    # rows 0 and 1 overflow and do not factor; row 2 has room, its Gram is not factored
    assert resets.tolist() == [6, 1, 0] and out.k.tolist() == [2, 2, 4]
