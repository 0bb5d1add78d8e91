"""Port parity for the dense/low-rank/CG ops: the same numpy inputs go through
``free_hunch_tpu.ops`` (JAX, CPU) and ``free_hunch_tpu_torch.ops`` (torch,
CPU). JAX gets explicit float32 arrays (tests/conftest.py enables x64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops import cg as jcg
from free_hunch_tpu.ops import dct as jdct
from free_hunch_tpu.ops import fftops as jfft
from free_hunch_tpu.ops import lowrank as jlr
from free_hunch_tpu_torch.ops import cg as tcg
from free_hunch_tpu_torch.ops import dct as tdct
from free_hunch_tpu_torch.ops import fftops as tfft
from free_hunch_tpu_torch.ops import lowrank as tlr

F32 = np.float32


def _j(a):
    return jnp.asarray(np.asarray(a, F32))


def _t(a):
    return torch.as_tensor(np.asarray(a, F32))


# -- DCT: f32 matmuls against f32 matmuls; rtol=1e-5 covers summation order
# (256-term dots at eps_f32 = 1.2e-7), atol=1e-5 the near-zero outputs ----

@pytest.mark.parametrize("fn", ["dct_2d", "idct_2d", "dct_1d", "idct_1d"])
def test_dct_matches_jax(fn):
    x = np.random.default_rng(0).normal(size=(2, 3, 32, 24)).astype(F32)
    want = np.asarray(getattr(jdct, fn)(_j(x)))
    got = getattr(tdct, fn)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dct_roundtrip_is_identity():
    x = _t(np.random.default_rng(1).normal(size=(1, 3, 16, 16)))
    np.testing.assert_allclose(tdct.idct_2d(tdct.dct_2d(x)).numpy(), x.numpy(),
                               atol=2e-6)


@pytest.mark.parametrize("flag", ["matmul", "cudnn"])
def test_entry_points_turn_tf32_off_and_the_algebra_checks_it(flag, monkeypatch,
                                                              tmp_path):
    """Full f32 is the port's policy, not the caller's: the DCT refuses an
    f32 CUDA tensor while either TF32 flag is on, and ``load_model`` and
    ``sample_loop`` turn both off."""
    import free_hunch_tpu_torch as fht
    from free_hunch_tpu_torch.models import loading as tload
    from free_hunch_tpu_torch.samplers import edm as tedm
    flags = {"matmul": torch.backends.cuda.matmul, "cudnn": torch.backends.cudnn}
    for mod in flags.values():
        monkeypatch.setattr(mod, "allow_tf32", False)
    fake_cuda = type("CudaF32", (), dict(is_cuda=True, dtype=torch.float32))()
    fht.check_full_f32(fake_cuda)
    monkeypatch.setattr(flags[flag], "allow_tf32", True)
    with pytest.raises(RuntimeError, match="use_full_f32"):
        tdct.dct_2d(fake_cuda)
    no_steps = dict(use_heun=np.zeros(0, bool))
    tedm.sample_loop(None, type("NoGuidance", (), dict(init_state=lambda *a: None))(),
                     torch.zeros(1, 3, 4, 4), None, no_steps, sigma0_scaled=1.0)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    fht.check_full_f32(fake_cuda)
    monkeypatch.setattr(flags[flag], "allow_tf32", True)
    setup = tmp_path / "setup.txt"
    setup.write_text("--attention_resolutions 8 --image_size 8 --num_channels 32 "
                     "--num_head_channels 16 --num_res_blocks 1 --channel_mult 1")
    tload.load_model("", str(setup), device="cpu", init_random_if_missing=True)
    assert not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)


def test_p2o_and_fft_conv_match_jax():
    rng = np.random.default_rng(2)
    psf = rng.uniform(size=(7, 7)).astype(F32)
    psf /= psf.sum()
    FB = jfft.p2o_np(psf.reshape(1, 1, 7, 7), (16, 16))
    np.testing.assert_array_equal(tfft.p2o_np(psf.reshape(1, 1, 7, 7), (16, 16)), FB)
    x = rng.normal(size=(2, 3, 16, 16)).astype(F32)
    want = np.asarray(jfft.fft_conv(_j(x), jnp.asarray(FB)))
    got = tfft.fft_conv(_t(x), torch.as_tensor(FB)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- LowRank: batched torch vs vmapped JAX, compared as dense matrices -----

def _rep_np(seed, b=3, d=20, K=6, ks=(2, 4, 0)):
    rng = np.random.default_rng(seed)
    diag = rng.uniform(1.0, 2.0, (b, d)).astype(F32)
    Ut = np.zeros((b, K, d), F32)
    M = np.tile(np.eye(K, dtype=F32), (b, 1, 1))
    for i, k in enumerate(ks):
        Ut[i, :k] = rng.normal(size=(k, d)) * 0.3
        a = rng.normal(size=(k, k)) * 0.5
        M[i, :k, :k] = 0.5 * (a + a.T)
    return dict(diag=diag, Ut=Ut, M=M, k=np.asarray(ks, np.int64))


def _jrep(r):
    return jlr.LowRank(diag=_j(r["diag"]), Ut=_j(r["Ut"]), M=_j(r["M"]),
                       k=jnp.asarray(r["k"], jnp.int32))


def _trep(r):
    return tlr.LowRank(diag=_t(r["diag"]), Ut=_t(r["Ut"]), M=_t(r["M"]),
                       k=torch.as_tensor(r["k"]))


def _jdense(rep):
    return np.asarray(jax.vmap(jlr.dense)(rep))


# rtol=1e-5 on the dense reconstructions: f32 (K, d) products whose
# summation order differs between XLA and torch; atol=1e-6 for entries that
# cancel to ~0 (O(1) matrices)
_DENSE_TOL = dict(rtol=1e-5, atol=1e-6)


def test_lowrank_matvec_and_diag_match_jax():
    r = _rep_np(0)
    v = np.random.default_rng(1).normal(size=(3, 20)).astype(F32)
    want = np.asarray(jax.vmap(jlr.matvec)(_jrep(r), _j(v)))
    np.testing.assert_allclose(tlr.matvec(_trep(r), _t(v)).numpy(), want, **_DENSE_TOL)
    want = np.asarray(jax.vmap(jlr.diag_of)(_jrep(r)))
    np.testing.assert_allclose(tlr.diag_of(_trep(r)).numpy(), want, **_DENSE_TOL)
    np.testing.assert_allclose(tlr.dense(_trep(r)).numpy(), _jdense(_jrep(r)), **_DENSE_TOL)


@pytest.mark.parametrize("op", ["inverse", "affine", "shift_diag", "scale"])
def test_lowrank_algebra_matches_jax(op):
    r = _rep_np(2)
    r["diag"] += 3.0    # far from singular for a clean inverse
    args = {"inverse": (), "affine": (0.7, 1.5), "shift_diag": (-0.25,),
            "scale": (1.3,)}[op]
    want = _jdense(jax.vmap(lambda rep: getattr(jlr, op)(rep, *args))(_jrep(r)))
    got = tlr.dense(getattr(tlr, op)(_trep(r), *args)).numpy()
    np.testing.assert_allclose(got, want, **_DENSE_TOL)


def test_lowrank_compress_matches_jax():
    """Eigenvector signs and order may differ between libraries, so the
    represented U M U^T are compared, not the factors."""
    r = _rep_np(3, ks=(6, 5, 3))
    want_rep = jax.vmap(lambda rep: jlr.compress(rep, 4))(_jrep(r))
    got_rep = tlr.compress(_trep(r), 4)
    np.testing.assert_array_equal(got_rep.k.numpy(), np.asarray(want_rep.k))
    np.testing.assert_allclose(tlr.dense(got_rep).numpy(), _jdense(want_rep),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ks", [(0, 2, 4), (6, 4, 6)], ids=["room", "at_capacity"])
def test_lowrank_append_pair_matches_jax(ks):
    """Per-row writes at each row's own k; rows at capacity compress first."""
    r = _rep_np(4, ks=ks)
    rng = np.random.default_rng(5)
    a, bvec = rng.normal(size=(2, 3, 20)).astype(F32)
    wa = np.asarray([0.5, -0.3, 0.2], F32)
    wb = np.asarray([-0.1, 0.4, 0.3], F32)
    want = jax.vmap(jlr.append_pair)(_jrep(r), _j(a), _j(wa), _j(bvec), _j(wb))
    got = tlr.append_pair(_trep(r), _t(a), _t(wa), _t(bvec), _t(wb))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_allclose(tlr.dense(got).numpy(), _jdense(want), rtol=1e-5, atol=1e-5)


# -- CG: equal niter, iterates at rtol=1e-4 --------------------------------

def _run_both(mv_np_diag=None, A=None, b=None, **kw):
    """Run both CGs on a diagonal (elementwise) or dense SPD system."""
    if mv_np_diag is not None:
        dj, dt = _j(mv_np_diag), _t(mv_np_diag)
        jmv = lambda v: v * dj[None, :]  # noqa: E731
        tmv = lambda v: v * dt[None, :]  # noqa: E731
    else:
        Aj, At = _j(A), _t(A)
        jmv = lambda v: jnp.einsum("bij,bj->bi", Aj, v)  # noqa: E731
        tmv = lambda v: torch.einsum("bij,bj->bi", At, v)  # noqa: E731
    jkw, tkw = dict(kw), dict(kw)
    for key in ("x0", "rtol"):
        if isinstance(kw.get(key), np.ndarray):
            jkw[key], tkw[key] = _j(kw[key]), _t(kw[key])
    if kw.get("precond_diag") is not None:
        pj, pt = _j(kw["precond_diag"]), _t(kw["precond_diag"])
        jkw["precond"] = lambda v: v / pj[None, :]
        tkw["precond"] = lambda v: v / pt[None, :]
    jkw.pop("precond_diag", None)
    tkw.pop("precond_diag", None)
    xj, ij = jcg.cg_batch(jmv, _j(b), **jkw)
    xt, it = tcg.cg_batch(tmv, _t(b), **tkw)
    return (np.asarray(xj), ij, np.linalg.norm(b, axis=-1)), (xt.numpy(), it)


def _assert_same(j, t, rtol=1e-4):
    """Equal niter and optimal flags; iterates within ``rtol`` per row in
    the 2-norm (an elementwise test would be dominated by the components CG
    has not resolved yet, where f32 summation order moves each element)."""
    (xj, ij, b_norm), (xt, it) = j, t
    assert it.niter == int(ij.niter)
    np.testing.assert_array_equal(it.optimal.numpy(), np.asarray(ij.optimal))
    err = np.linalg.norm(xt - xj, axis=-1)
    assert (err <= rtol * np.linalg.norm(xj, axis=-1)).all(), err
    # residual norms of the returned iterates, on the scale of ||b||
    res_err = np.abs(it.residual_norm.numpy() - np.asarray(ij.residual_norm))
    assert (res_err <= rtol * b_norm).all(), res_err / b_norm


@pytest.mark.parametrize("track_best", [True, False])
def test_cg_dense_spd_per_row_rtol_matches_jax(track_best):
    rng = np.random.default_rng(6)
    n = 48
    A = rng.normal(size=(3, n, n)).astype(F32)
    A = A @ A.transpose(0, 2, 1) / n + 0.5 * np.eye(n, dtype=F32)
    b = rng.normal(size=(3, n)).astype(F32)
    j, t = _run_both(A=A, b=b, rtol=np.asarray([1e-2, 1e-4, 1e-3], F32),
                     maxiter=500, track_best=track_best)
    _assert_same(j, t)
    assert j[1].optimal.all()


def test_cg_warm_start_min_iter_and_preconditioner_match_jax():
    """x0 = b with one forced update at a loose rtol (the customcuda path)."""
    rng = np.random.default_rng(7)
    n = 256
    d = np.logspace(-2, 1, n).astype(F32)
    b = rng.normal(size=(2, n)).astype(F32)
    for rtol in (1.0, 1e-3):
        j, t = _run_both(mv_np_diag=d, b=b, x0=b, rtol=rtol, min_iter=1,
                         maxiter=300, precond_diag=d * 0.9 + 0.05)
        _assert_same(j, t)


def test_cg_stall_plateau_floor_check_matches_jax():
    """Ill-conditioned plateau (kappa 1e4): with an always-engaged counter
    the floor check fires, proves no floor, resets and keeps going. Both
    implementations take the same decisions at the same iterations."""
    rng = np.random.default_rng(8)
    n = 2048
    d = np.logspace(-4, 0, n).astype(F32)
    b = rng.standard_normal((1, n)).astype(F32)
    j, t = _run_both(mv_np_diag=d, b=b, rtol=1e-3, maxiter=2000, stall_iters=25,
                     stall_engage=np.inf)
    _assert_same(j, t)
    assert bool(j[1].optimal[0])
    # the legacy freeze without the floor check stops on the plateau
    j, t = _run_both(mv_np_diag=d, b=b, rtol=1e-3, maxiter=2000, stall_iters=25,
                     stall_engage=np.inf, stall_floor_check=False)
    _assert_same(j, t)
    assert not bool(j[1].optimal[0])


def test_cg_stall_freezes_at_f32_floor_like_jax():
    """rtol below the f32 floor: the stall counter fires, the floor check
    proves the floor, and the row freezes at the same iteration."""
    rng = np.random.default_rng(9)
    n = 64
    d = np.linspace(0.5, 2.0, n).astype(F32)
    b = rng.standard_normal((2, n)).astype(F32)
    j, t = _run_both(mv_np_diag=d, b=b, rtol=1e-12, maxiter=1000, stall_iters=25)
    _assert_same(j, t)
    assert int(j[1].niter) < 1000
    assert t[1].host_syncs == 2 * t[1].niter + 1
