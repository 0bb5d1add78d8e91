"""Port parity for the rest of ``ops``: single-system ``cg``, the
differentiable ``cg_solve`` (its value, and its gradient against
``torch.autograd.gradcheck`` and against ``jax.grad`` through
``lax.custom_linear_solve``), the FFT helpers ``fftn2``/``ifftn2``,
``p2o``, ``pre_calculate`` and ``data_solution``, the Haar wavelet and the
orthogonal-transform registry with ``LazyOTCovariance``. The same numpy
draws go through the JAX package and the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops import cg as jcg
from free_hunch_tpu.ops import fftops as jfft
from free_hunch_tpu.ops import ortho as jortho
from free_hunch_tpu_torch import ops as tops
from free_hunch_tpu_torch.ops import cg as tcg
from free_hunch_tpu_torch.ops import fftops as tfft
from free_hunch_tpu_torch.ops import ortho as tortho
from tests._torch_parity import one_thread  # noqa: F401

F32 = np.float32
SHAPE = (3, 8, 8)


def _spd(d, seed=0, cond=50.0):
    """An SPD matrix with eigenvalues from 1 to ``cond``."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return (q * np.geomspace(1.0, cond, d)) @ q.T


def test_ops_package_exports_what_the_jax_package_exports():
    import free_hunch_tpu.ops as jops
    for name in ("dct_2d", "idct_2d", "dct_matrix", "p2o", "pre_calculate", "upsample",
                 "downsample", "splits", "cg_batch", "cg_solve"):
        assert hasattr(jops, name) and callable(getattr(tops, name)), name
    for name in ("fftn2", "ifftn2", "data_solution"):
        assert callable(getattr(tops, name)), name
    # the submodule stays reachable under its own name
    assert tops.cg is tcg


@pytest.mark.parametrize("rtol", [1e-3, 1e-8])
def test_cg_single_system_matches_jax(rtol):
    """f64 on both sides: equal iteration counts, x within 1e-8 of max |x|
    (the two summation orders differ by 5e-9 of it after the 1e-8 solve's
    iterations on a system of condition 50)."""
    d = int(np.prod(SHAPE))
    A = _spd(d)
    b = np.random.default_rng(1).normal(size=SHAPE)
    jx, jinfo = jcg.cg(lambda v: (jnp.asarray(A) @ v.reshape(-1)).reshape(SHAPE),
                       jnp.asarray(b), rtol=rtol)
    At = torch.as_tensor(A)
    tx, tinfo = tcg.cg(lambda v: (At @ v.reshape(-1)).reshape(SHAPE), torch.as_tensor(b),
                       rtol=rtol)
    assert tx.shape == SHAPE and tinfo.niter == int(jinfo.niter)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(jx)).max())
    assert bool(tinfo.optimal[0]) == bool(jinfo.optimal[0])


def _solve_both(A, b, w):
    """loss = <w, A^-1 b> and its gradients with respect to b and A, in
    both packages (f64)."""
    def jloss(Aj, bj):
        x = jcg.cg_solve(lambda v: (Aj @ v.reshape(-1)).reshape(SHAPE), bj, rtol=1e-12)
        return jnp.sum(jnp.asarray(w) * x), x

    (jl, jx), (jgA, jgb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(A), jnp.asarray(b))
    At = torch.as_tensor(A).requires_grad_(True)
    bt = torch.as_tensor(b).requires_grad_(True)
    tx = tcg.cg_solve(lambda v: (At @ v.reshape(-1)).reshape(SHAPE), bt, rtol=1e-12)
    tl = torch.sum(torch.as_tensor(w) * tx)
    tgA, tgb = torch.autograd.grad(tl, (At, bt))
    return (np.asarray(jx), np.asarray(jgb), np.asarray(jgA)), (
        tx.detach().numpy(), tgb.numpy(), tgA.numpy())


def test_cg_solve_value_and_gradients_match_jax_custom_linear_solve():
    """The value, the gradient of b (a second solve) and the gradient of
    the matrix the matvec closes over (-A^-1 w x^T) equal ``jax.grad``
    through ``lax.custom_linear_solve(symmetric=True)`` within 1e-9 of
    their scale (both f64, both solves at rtol 1e-12)."""
    d = int(np.prod(SHAPE))
    rng = np.random.default_rng(2)
    A, b, w = _spd(d, 3), rng.normal(size=SHAPE), rng.normal(size=SHAPE)
    for want, got in zip(*_solve_both(A, b, w)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    # and the closed forms
    x = np.linalg.solve(A, b.reshape(-1))
    lam = np.linalg.solve(A, w.reshape(-1))
    _, (tx, tgb, tgA) = _solve_both(A, b, w)
    np.testing.assert_allclose(tx.reshape(-1), x, rtol=0, atol=1e-9 * np.abs(x).max())
    np.testing.assert_allclose(tgb.reshape(-1), lam, rtol=0, atol=1e-9 * np.abs(lam).max())
    np.testing.assert_allclose(tgA, -np.outer(lam, x), rtol=0,
                               atol=1e-9 * np.abs(np.outer(lam, x)).max())


def test_cg_solve_passes_gradcheck():
    """``torch.autograd.gradcheck`` (f64 finite differences, its default
    tolerances) on b and on the matrix the matvec closes over."""
    A = torch.as_tensor(_spd(12, 4, cond=10.0)).requires_grad_(True)
    b = torch.as_tensor(np.random.default_rng(5).normal(size=(3, 4))).requires_grad_(True)

    def f(M, bb):
        return tcg.cg_solve(lambda v: (M @ v.reshape(-1)).reshape(3, 4), bb, rtol=1e-13)

    assert torch.autograd.gradcheck(f, (A, b))


def test_cg_solve_without_gradients_is_the_plain_solve():
    A = torch.as_tensor(_spd(12, 6))
    b = torch.as_tensor(np.random.default_rng(7).normal(size=(12,)))
    with torch.no_grad():
        x = tcg.cg_solve(lambda v: A @ v, b, rtol=1e-12)
    want, _ = tcg.cg(lambda v: A @ v, b, rtol=1e-12)
    assert not x.requires_grad and torch.equal(x, want)


def test_fftn2_ifftn2_match_jax():
    x = np.random.default_rng(8).normal(size=(2, 3, 16, 12)).astype(F32)
    got = tfft.fftn2(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfft.fftn2(jnp.asarray(x))), rtol=0, atol=1e-4)
    back = tfft.ifftn2(torch.as_tensor(got)).real.numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ks,grid", [(5, (16, 16)), (9, (16, 12)), (21, (16, 16))])
def test_p2o_matches_jax_and_the_host_twin(ks, grid):
    """complex64 OTFs within 1e-6 (the PSF sums to 1); a 21x21 PSF is
    centre-cropped to the 16 px grid as in both packages."""
    psf = np.random.default_rng(ks).uniform(0.1, 1.0, (1, 1, ks, ks)).astype(F32)
    psf /= psf.sum()
    got = tfft.p2o(torch.as_tensor(psf), grid).numpy()
    np.testing.assert_allclose(got, np.asarray(jfft.p2o(jnp.asarray(psf), grid)), atol=1e-6)
    np.testing.assert_allclose(got, tfft.p2o_np(psf, grid), atol=1e-6)


def _hqs_inputs(seed=21, sf=2):
    rng = np.random.default_rng(seed)
    x_true = rng.normal(size=(1, 3, 16, 16)).astype(F32)
    k = rng.uniform(0.1, 1, (1, 1, 5, 5)).astype(F32)
    k /= k.sum()
    FB = tfft.p2o(torch.as_tensor(k).to(torch.complex64), (16, 16))
    y = tfft.downsample(tfft.fft_conv(torch.as_tensor(x_true), FB), sf)
    return x_true, k, y.numpy()


@pytest.mark.parametrize("alpha", [0.1, 2.0])
def test_pre_calculate_and_data_solution_match_jax(alpha):
    """The FFT tuple within 1e-5 and the half-quadratic data step within
    1e-5 of the JAX package's (complex64 on both sides); the step fits the
    measurement better than its zero start."""
    sf = 2
    x_true, k, y = _hqs_inputs(sf=sf)
    tpre = tfft.pre_calculate(torch.as_tensor(y), torch.as_tensor(k), sf)
    jpre = jfft.pre_calculate(jnp.asarray(y), jnp.asarray(k), sf)
    for t, j in zip(tpre, jpre):
        assert t.dtype in (torch.complex64, torch.float32)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    x0 = np.random.default_rng(3).normal(size=x_true.shape).astype(F32) * 0.1
    got = tfft.data_solution(torch.as_tensor(x0), *tpre, alpha, sf)
    want = np.asarray(jfft.data_solution(jnp.asarray(x0), *jpre, alpha, sf))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    def resid(x):
        return float(torch.sum((tfft.downsample(tfft.fft_conv(x, tpre[0]), sf)
                                - torch.as_tensor(y)) ** 2))
    assert resid(got) < resid(torch.zeros_like(got))


def test_haar_round_trip_orthonormal_and_equal_to_jax():
    """f64: the inverse recovers x within 1e-12, the level-3 transform of
    an 8x8 grid is an orthogonal matrix, and both directions equal the JAX
    package's within 1e-12."""
    x = np.random.default_rng(0).normal(size=(2, 3, 16, 16))
    w = tortho.haar_dwt2(torch.as_tensor(x), level=3)
    np.testing.assert_allclose(tortho.haar_idwt2(w, level=3).numpy(), x, atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.asarray(jortho.haar_dwt2(jnp.asarray(x), 3)),
                               atol=1e-12)
    np.testing.assert_allclose(tortho.haar_idwt2(w, 3).numpy(),
                               np.asarray(jortho.haar_idwt2(jnp.asarray(w.numpy()), 3)),
                               atol=1e-12)
    W = tortho.haar_dwt2(torch.eye(64, dtype=torch.float64).reshape(64, 8, 8), 3).reshape(64, 64)
    np.testing.assert_allclose((W @ W.T).numpy(), np.eye(64), atol=1e-12)


def test_ortho_transforms_and_lazy_covariance_match_jax():
    """Identity, 'dct' and 'dwt' forward and inverse, and W^T diag(v) W,
    in f32 against the JAX package within 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 3, 8, 8)).astype(F32)
    var = rng.uniform(0.5, 2.0, x.shape).astype(F32)
    for kind, kw in ((None, {}), ("dct", {}), ("dwt", dict(level=2))):
        t, j = tortho.OrthoTransform(kind, **kw), jortho.OrthoTransform(kind, **kw)
        fx = t(torch.as_tensor(x))
        np.testing.assert_allclose(fx.numpy(), np.asarray(j(jnp.asarray(x))), atol=1e-5)
        np.testing.assert_allclose(t.inv(fx).numpy(), x, atol=1e-5)
        tc = tortho.LazyOTCovariance(t, torch.as_tensor(var))
        jc = jortho.LazyOTCovariance(j, jnp.asarray(var))
        np.testing.assert_allclose(tc.transpose(torch.as_tensor(x)).numpy(),
                                   np.asarray(jc(jnp.asarray(x))), atol=1e-5)
    with pytest.raises(ValueError):
        tortho.OrthoTransform("dwt", wavelet="db2")
