"""Port parity for the Free Hunch covariance updates: batched torch
functions against the JAX ones under ``vmap``, on the same float32 numpy
inputs. States are compared as the dense matrices they represent."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.guidance import covariance as jcov
from free_hunch_tpu.ops import lowrank as jlr
from free_hunch_tpu_torch.guidance import covariance as tcov
from free_hunch_tpu_torch.ops import lowrank as tlr

F32 = np.float32
B, D, K = 3, 24, 8


def _state(seed, ks=(0, 2, 4)):
    """A covariance state with a spread diagonal (like the DCT prior) and
    PSD low-rank columns of varied rank per row."""
    rng = np.random.default_rng(seed)
    diag = np.logspace(-2, 1, D)[None].repeat(B, 0).astype(F32)
    diag *= rng.uniform(0.8, 1.2, (B, D)).astype(F32)
    Ut = np.zeros((B, K, D), F32)
    M = np.tile(np.eye(K, dtype=F32), (B, 1, 1))
    for i, k in enumerate(ks):
        Ut[i, :k] = rng.normal(size=(k, D)) / np.sqrt(D)
        M[i, :k, :k] = np.diag(rng.uniform(0.1, 0.5, k))
    j = jlr.LowRank(diag=jnp.asarray(diag), Ut=jnp.asarray(Ut), M=jnp.asarray(M),
                    k=jnp.asarray(ks, jnp.int32))
    t = tlr.LowRank(diag=torch.as_tensor(diag), Ut=torch.as_tensor(Ut),
                    M=torch.as_tensor(M), k=torch.as_tensor(ks, dtype=torch.int64))
    return j, t


def _dense_close(t_rep, j_rep, rtol=1e-4, atol=1e-6):
    want = np.asarray(jax.vmap(jlr.dense)(j_rep))
    np.testing.assert_allclose(tlr.dense(t_rep).numpy(), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


# rtol=1e-4: two f32 Woodbury inverses of matrices whose diagonal spans three
# decades (condition ~1e3) amplify the 1e-7 rounding to ~1e-5..1e-4
@pytest.mark.parametrize("sigmas", [(80.0, 40.0), (12.0, 7.5), (3.0, 1.2)])
def test_time_update_matches_jax(sigmas):
    s, s2 = (float(F32(v)) for v in sigmas)
    j, t = _state(0)
    want = jax.vmap(jcov.time_update, in_axes=(0, None, None))(j, F32(s), F32(s2))
    _dense_close(tcov.time_update(t, s, s2), want)


@pytest.mark.parametrize("formula", ["telescoped", "two_inverse"])
@pytest.mark.parametrize("sigmas", [(20.0, 12.0), (2.0, 1.5)])
def test_transport_matches_jax(formula, sigmas):
    s, s2 = (float(F32(v)) for v in sigmas)
    j, t = _state(1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, D)).astype(F32)
    score = rng.normal(size=(B, D)).astype(F32)
    jf = (jcov.transport_score if formula == "telescoped"
          else jcov.transport_score_two_inverse)
    tf = (tcov.transport_score if formula == "telescoped"
          else tcov.transport_score_two_inverse)
    jm, js = jax.vmap(jf, in_axes=(0, 0, None, None, 0, 0))(
        j, j, F32(s), F32(s2), jnp.asarray(x), jnp.asarray(score))
    tm, ts = tf(t, t, s, s2, torch.as_tensor(x), torch.as_tensor(score))
    # the two-inverse form runs through near-singular operators (its JAX
    # docstring measures ~5 lost digits); the telescoped form is SPD
    tol = 1e-4 if formula == "telescoped" else 2e-3
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=tol,
                               atol=tol * np.abs(np.asarray(js)).max())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=tol,
                               atol=tol * np.abs(np.asarray(jm)).max())


@pytest.mark.parametrize("params", [
    jcov.CovParams(),
    jcov.CovParams(curvature_guard=False),
    jcov.CovParams(secant_novelty_min=0.0),
    jcov.CovParams(project_to_diagonal=True),
], ids=["guarded", "reference", "no_novelty", "diagonal"])
def test_space_update_matches_jax(params):
    """Row 0 has a valid secant pair, row 1 negative curvature, row 2 a pair
    the state already explains (skipped by the novelty guard)."""
    j, t = _state(3, ks=(2, 4, 0))
    rng = np.random.default_rng(4)
    sigma = float(F32(3.5))
    x = rng.normal(size=(B, D)).astype(F32)
    dx = rng.normal(size=(B, D)).astype(F32) * 0.1
    x2 = x + dx
    m1 = rng.normal(size=(B, D)).astype(F32) * 0.1
    m2 = m1 + (rng.uniform(0.05, 0.3, (B, D)) * dx).astype(F32)
    m2[1] = m1[1] - dx[1]                    # dx . de < 0
    sdx = np.asarray(jax.vmap(jlr.matvec)(j, jnp.asarray(dx)))[2]
    m2[2] = m1[2] + sdx / sigma**2           # de == Sigma dx exactly
    ja = [jnp.asarray(a) for a in (x, x2, m1, m2)]
    want = jax.vmap(jcov.space_update, in_axes=(0, None, 0, 0, 0, 0, None))(
        j, F32(sigma), *ja, params)
    got = tcov.space_update(t, sigma, *(torch.as_tensor(a) for a in (x, x2, m1, m2)),
                            tcov.CovParams(*params))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    _dense_close(got, want)


def test_init_state_and_hessian_matvecs_match_jax():
    rng = np.random.default_rng(5)
    var = rng.uniform(0.1, 2.0, D).astype(F32)
    t = tcov.init_state(torch.as_tensor(var), B, D, K)
    j = jcov.init_state(jnp.asarray(var), D, K)
    np.testing.assert_array_equal(t.diag.numpy()[0], np.asarray(j.diag))
    _, tr = _state(6)
    jr, _ = _state(6)
    v = rng.normal(size=(B, D)).astype(F32)
    sigma = float(F32(0.9))
    for jf, tf in ((lambda c, vv: jcov.hessian_matvec(c, F32(sigma), vv),
                    lambda c, vv: tcov.hessian_matvec(c, sigma, vv)),
                   (lambda c, vv: jcov.inv_hessian_matvec(c, F32(sigma), vv),
                    lambda c, vv: tcov.inv_hessian_matvec(c, sigma, vv)),
                   (lambda c, vv: jcov.inv_cov_matvec(c, vv), tcov.inv_cov_matvec)):
        want = np.asarray(jax.vmap(jf)(jr, jnp.asarray(v)))
        got = tf(tr, torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
