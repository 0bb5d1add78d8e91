"""Port parity for the guidance solvers: the same seeded numpy inputs through
the JAX package's ``free_hunch_tpu/guidance/solvers.py`` and the port on the
CPU, at 32 and 64 px.

* Closed forms: ``mat`` (and the returned u) within 1e-5 of max |mat|.
* CG solvers (deblur in pixel and in weighted-rfft2 coordinates,
  super-resolution, inpainting) with a scalar, a per-pixel and a
  covariance-matvec variance: ``mat`` within 1e-4 of max |mat| and equal
  ``niter``. Both packages stop at rtol along their own f32 rounding paths.
* The Fourier-coordinate solver against the pixel one (float64, as
  ``tests/test_solvers.py`` does for the JAX package), solution recycling,
  ``rtol_schedule_2`` and ``choose_solver``'s dispatch and errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.guidance import solvers as JS
from free_hunch_tpu.operators import get_operator as jget
from free_hunch_tpu_torch.guidance import solvers as TS
from free_hunch_tpu_torch.operators import get_operator as tget
from tests._torch_parity import one_thread  # noqa: F401

F32 = np.float32
B = 2
K = 3   # low-rank columns of the covariance matvec


def _pair(name, res, sigma_s=0.1, kernel=None):
    kw = dict(in_shape=(1, 3, res, res), sigma_s=sigma_s)
    if name == "inpainting":
        rng = np.random.default_rng(res)
        kw["mask"] = np.repeat((rng.uniform(size=(1, 1, res, res)) > 0.3).astype(F32), 3, 1)
    if kernel is not None:
        kw["kernel"] = kernel
    return jget(name, **kw), tget(name, device="cpu", **kw)


class _Case:
    """x0, y and the three kinds of variance, as numpy, for one operator."""

    def __init__(self, name, res, seed=0):
        self.jo, self.to = _pair(name, res)
        rng = np.random.default_rng(seed)
        shape = (B, 3, res, res)
        self.x0 = rng.uniform(-1, 1, shape).astype(F32)
        truth = rng.uniform(-1, 1, shape).astype(F32)
        self.y = np.asarray(self.jo.forward(jnp.asarray(truth), noiseless=True))
        self.var_scalar = F32(0.3)
        self.var_pixel = rng.uniform(0.05, 1.5, shape).astype(F32)
        self.d = rng.uniform(0.05, 1.0, shape).astype(F32)
        self.U = (rng.normal(size=(B, K) + shape[1:]) / np.sqrt(np.prod(shape[1:]))).astype(F32)
        self.trace = (self.d.reshape(B, -1).mean(-1)
                      + (self.U ** 2).reshape(B, K, -1).sum(-1).sum(-1) / np.prod(shape[1:]))
        # a spectrum as Free Hunch hands it over: a DCT diagonal mapped onto
        # the DFT grid, symmetric under k -> n - k like a real image's
        self.spec = TS._dct_spec_to_fourier(
            torch.as_tensor(rng.uniform(0.05, 1.0, shape).astype(F32))).numpy()

    def jcov(self, v):
        d, U = jnp.asarray(self.d), jnp.asarray(self.U)
        return d * v + jnp.einsum("bk...,bk->b...", U, jnp.einsum("bk...,b...->bk", U, v))

    def tcov(self, v):
        d, U = torch.as_tensor(self.d), torch.as_tensor(self.U)
        return d * v + torch.einsum("bk...,bk->b...", U, torch.einsum("bk...,b...->bk", U, v))

    def kwargs(self, kind):
        """(JAX kwargs, port kwargs) of one variance kind."""
        if kind == "scalar":
            return (dict(theta0_var=jnp.asarray(self.var_scalar)),
                    dict(theta0_var=float(self.var_scalar)))
        if kind == "pixel":
            return (dict(theta0_var=jnp.asarray(self.var_pixel)),
                    dict(theta0_var=torch.as_tensor(self.var_pixel)))
        j = dict(cov_mv=self.jcov, cov_trace_mean=jnp.asarray(self.trace, jnp.float32))
        t = dict(cov_mv=self.tcov, cov_trace_mean=torch.as_tensor(self.trace, dtype=torch.float32))
        if kind == "cov_spec":
            j["cov_fourier_spec"] = jnp.asarray(self.spec)
            t["cov_fourier_spec"] = torch.as_tensor(self.spec)
        return j, t

    def args(self):
        return ((self.jo, jnp.asarray(self.y), jnp.asarray(self.x0)),
                (self.to, torch.as_tensor(self.y), torch.as_tensor(self.x0)))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("sigma", [0.01, 0.05, 0.2, 1.0, 3.0, 14.0, 79.0, 120.0])
def test_rtol_schedules_match_jax(sigma):
    np.testing.assert_allclose(TS.rtol_schedule_2(sigma), float(JS.rtol_schedule_2(sigma)),
                               rtol=1e-6)
    np.testing.assert_allclose(TS.rtol_schedule_2(sigma, 0.5, 1e-3, 0.1),
                               float(JS.rtol_schedule_2(sigma, 0.5, 1e-3, 0.1)), rtol=1e-6)


CLOSED = [("gaussian_blur", "deblur_mat_closed_form"),
          ("super_resolution", "sr_mat_closed_form"),
          ("inpainting", "inpainting_mat_closed_form")]


@pytest.mark.parametrize("res", [32, 64])
@pytest.mark.parametrize("name,fn", CLOSED)
def test_closed_forms_match_jax(name, fn, res):
    c = _Case(name, res)
    (ja, jkw), (ta, tkw) = zip(c.args(), c.kwargs("scalar"))
    jm, ju = getattr(JS, fn)(*ja, jkw["theta0_var"], return_u=True)
    tm, tu = getattr(TS, fn)(*ta, tkw["theta0_var"], return_u=True)
    _close(tm.numpy(), jm, 1e-5)
    _close(tu.numpy(), ju, 1e-5)
    assert tu.shape == tuple(c.to.out_shape[1:]) or tu.shape[1:] == tuple(c.to.out_shape[1:])


CG = [("gaussian_blur", "deblur_mat_cg"), ("gaussian_blur", "deblur_mat_cg_fourier"),
      ("super_resolution", "sr_mat_cg"), ("inpainting", "inpainting_mat_cg")]


@pytest.mark.parametrize("kind", ["scalar", "pixel", "cov", "cov_spec"])
@pytest.mark.parametrize("name,fn", CG)
@pytest.mark.parametrize("res", [32, 64])
def test_cg_solvers_match_jax(name, fn, kind, res):
    """The 'cg' method's configuration (warm start at b, one forced update)
    with the preconditioner each variance kind selects; ``cov_spec`` adds
    the spectral preconditioner (inpainting ignores it)."""
    c = _Case(name, res, seed=1)
    (ja, jkw), (ta, tkw) = zip(c.args(), c.kwargs(kind))
    common = dict(rtol=1e-4, maxiter=400, return_info=True, warm_start=True, min_iter=1)
    jm, ji = getattr(JS, fn)(*ja, **jkw, **common)
    tm, ti = getattr(TS, fn)(*ta, **tkw, **common)
    assert ti.niter == int(ji.niter) > 0
    _close(tm.numpy(), jm, 1e-4)
    # final residuals near the f32 floor differ by rounding (up to 1.7x
    # observed); the check catches one reported on the wrong scale (the
    # Fourier solver's sqrt(H*W) = 32-64)
    ratio = ti.residual_norm.numpy() / np.asarray(ji.residual_norm)
    assert np.all((ratio > 0.25) & (ratio < 4)), ratio
    np.testing.assert_array_equal(ti.optimal.numpy(), np.asarray(ji.optimal))


def test_sr_spectral_preconditioner_gathers_folded_indices(monkeypatch):
    """The SR preconditioner's low-resolution spectrum comes from the folded
    indices min(j, n - j) * sf. The CG count is what shows it: an ascending
    corner slice (0 .. n - 1) has the right shape and reaches the same
    ``mat``, but takes another number of iterations."""
    c = _Case("super_resolution", 64, seed=2)
    (ja, jkw), (ta, tkw) = zip(c.args(), c.kwargs("cov_spec"))
    common = dict(rtol=1e-5, maxiter=400, return_info=True)
    jm, ji = JS.sr_mat_cg(*ja, **jkw, **common)
    tm, ti = TS.sr_mat_cg(*ta, **tkw, **common)
    assert ti.niter == int(ji.niter)
    _close(tm.numpy(), jm, 1e-4)
    monkeypatch.setattr(TS, "_sr_low_idx", lambda n, sf, device=None:
                        torch.arange(n // sf, device=device))
    wm, wi = TS.sr_mat_cg(*ta, **tkw, **common)
    assert wi.niter != ti.niter
    _close(wm.numpy(), tm.numpy(), 1e-3)


def _f64(op):
    """The operator with complex128/float64 constants, for float64 solves."""
    for k in ("FB", "FBC"):
        setattr(op, k, getattr(op, k).to(torch.complex128))
    op.F2B = op.F2B.double()
    return op


def _blur_case(seed, res=16):
    rng = np.random.default_rng(seed)
    k = rng.uniform(0.1, 1, (7, 7))
    jo, to = _pair("gaussian_blur", res, sigma_s=0.3, kernel=(k / k.sum()).astype(F32))
    x0 = rng.normal(size=(B, 3, res, res))
    y = to.forward(torch.as_tensor(rng.normal(size=(B, 3, res, res)), dtype=torch.float32),
                   noiseless=True).double()
    return jo, to, torch.as_tensor(x0), y, rng


def test_fourier_cg_matches_pixel_cg_tight_rtol():
    """Mirror of tests/test_solvers.py::test_fourier_cg_matches_pixel_cg for
    the port: at rtol 1e-11 in float64 both coordinate systems reach the
    same solution within one iteration of each other."""
    _, to, x0, y, rng = _blur_case(31)
    var = torch.as_tensor(rng.uniform(0.3, 1.5, tuple(x0.shape)))
    op = _f64(to)
    kw = dict(theta0_var=var, rtol=1e-11, maxiter=400, return_info=True, warm_start=True,
              min_iter=1, precondition=True, stall_iters=10**6)
    mat_p, info_p = TS.deblur_mat_cg(op, y, x0, **kw)
    mat_f, info_f = TS.deblur_mat_cg_fourier(op, y, x0, **kw)
    assert float((mat_p - mat_f).abs().max()) < 1e-8 * float(mat_p.abs().max())
    assert abs(info_p.niter - info_f.niter) <= 1
    assert torch.equal(info_p.optimal, info_f.optimal)
    assert bool((info_p.residual_norm < 1e-9).all() and (info_f.residual_norm < 1e-9).all())


def test_fourier_cg_loose_rtol_same_iterates():
    """Mirror of tests/test_solvers.py::test_fourier_cg_loose_rtol_same_iterates:
    the same number of iterations and the same iterate, residual norms on
    the pixel scale."""
    _, to, x0, y, _ = _blur_case(41)
    op = _f64(to)
    kw = dict(theta0_var=2.5, rtol=3e-2, maxiter=400, return_info=True, warm_start=True,
              min_iter=1, precondition=True, stall_iters=25)
    mat_p, info_p = TS.deblur_mat_cg(op, y, x0, **kw)
    mat_f, info_f = TS.deblur_mat_cg_fourier(op, y, x0, **kw)
    assert info_p.niter == info_f.niter
    assert float((mat_p - mat_f).abs().max()) < 1e-9 * float(mat_p.abs().max())
    np.testing.assert_allclose(info_f.residual_norm.numpy(), info_p.residual_norm.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("tight", [True, False])
def test_fourier_and_pixel_cg_take_the_same_iterations_in_f32(tight):
    """On the card's f32 path the two coordinate systems also agree on
    ``niter`` at the rtol the Free Hunch slices ask for."""
    c = _Case("gaussian_blur", 64, seed=4)
    _, (ta, tkw) = zip(c.args(), c.kwargs("cov_spec"))
    kw = dict(rtol=1e-5 if tight else 3e-2, maxiter=400, return_info=True, warm_start=True,
              min_iter=1)
    mat_p, info_p = TS.deblur_mat_cg(*ta, **tkw, **kw)
    mat_f, info_f = TS.deblur_mat_cg_fourier(*ta, **tkw, **kw)
    assert info_p.niter == info_f.niter
    _close(mat_f.numpy(), mat_p.numpy(), 1e-4)


def test_u_init_recycling_and_return_u():
    """Mirror of tests/test_solvers.py:272-340 for the port: a solve started
    at a previous solve's u stops at once; an invalid recycle takes the cold
    path; the Fourier solver shares the pixel-space u; a closed form's u is
    exact, and inpainting's u is its mat."""
    _, to, x0, y, _ = _blur_case(61)
    x0, y = x0.float(), y.float()
    kw = dict(theta0_var=0.5, rtol=1e-5, maxiter=300, return_info=True, precondition=False)
    mat1, info1, u1 = TS.deblur_mat_cg(to, y, x0, return_u=True, **kw)
    assert info1.niter > 3
    mat2, info2, _ = TS.deblur_mat_cg(to, y, x0, return_u=True, u_init=u1, u_init_valid=True,
                                      **kw)
    assert info2.niter == 0
    _close(mat2.numpy(), mat1.numpy(), 1e-5)
    mat3, info3, _ = TS.deblur_mat_cg(to, y, x0, return_u=True, u_init=u1, u_init_valid=False,
                                      **kw)
    assert info3.niter == info1.niter
    np.testing.assert_allclose(mat3.numpy(), mat1.numpy(), rtol=1e-6)
    kw.pop("precondition")
    mat_p, _, u_p = TS.deblur_mat_cg(to, y, x0, return_u=True, **kw)
    mat_f, info_f, u_f = TS.deblur_mat_cg_fourier(to, y, x0, return_u=True, u_init=u_p,
                                                  u_init_valid=True, **kw)
    assert info_f.niter == 0
    _close(u_f.numpy(), u_p.numpy(), 1e-4)
    _close(mat_f.numpy(), mat_p.numpy(), 1e-4)
    mat_cf, u_cf = TS.deblur_mat_closed_form(to, y, x0, 0.7, return_u=True)
    _close(to.transpose(u_cf).numpy(), mat_cf.numpy(), 1e-5)
    _, info, _ = TS.deblur_mat_cg(to, y, x0, theta0_var=0.7, rtol=1e-4, maxiter=300,
                                  return_info=True, return_u=True, u_init=u_cf,
                                  u_init_valid=True)
    assert info.niter == 0
    c = _Case("inpainting", 32)
    m_ip, u_ip = TS.inpainting_mat_closed_form(*c.args()[1], 0.7, return_u=True)
    assert torch.equal(m_ip, u_ip)
    c = _Case("super_resolution", 32)
    m_sr, u_sr = TS.sr_mat_closed_form(*c.args()[1], 0.7, return_u=True)
    assert u_sr.shape == (B, 3, 8, 8)
    _, info, _ = TS.sr_mat_cg(*c.args()[1], theta0_var=0.7, rtol=1e-4, maxiter=300,
                              return_info=True, return_u=True, u_init=u_sr, u_init_valid=True)
    assert info.niter == 0


@pytest.mark.parametrize("kind", ["scalar", "pixel"])
@pytest.mark.parametrize("method", ["closed_form", "cg", "customscipy"])
@pytest.mark.parametrize("name", ["gaussian_blur", "motion_blur", "super_resolution",
                                  "inpainting"])
def test_choose_solver_matches_jax(name, method, kind):
    """Every operator x solver family x variance kind through the dispatch,
    with ``cg_coords='auto'`` (Fourier on the CPU in both packages), sigma_t
    0.5 and the scipy paths' ``rtol_schedule_2``: the same ``mat`` and CG
    count; closed forms report 0 iterations and no host sync. 'scipy',
    'customcuda' are the same paths as 'closed_form' and 'cg' (below)."""
    c = _Case(name, 32, seed=3)
    (ja, jkw), (ta, tkw) = zip(c.args(), c.kwargs(kind))
    kw = dict(method=method, sigma_t=0.5, use_rtol_func=True, return_info=True)
    jm, ji = JS.choose_solver(*ja, **jkw, **kw)
    tm, ti = TS.choose_solver(*ta, **tkw, **kw)
    assert ti.niter == int(ji.niter)
    closed = method == "closed_form" and kind == "scalar"
    assert (ti.niter == 0 and ti.host_syncs == 0) if closed else ti.niter > 0
    _close(tm.numpy(), jm, 1e-5 if closed else 1e-4)


@pytest.mark.parametrize("alias,method", [("scipy", "closed_form"), ("customcuda", "cg")])
@pytest.mark.parametrize("kind", ["scalar", "pixel"])
def test_choose_solver_method_aliases(alias, method, kind):
    """'scipy' takes the closed form's path and 'customcuda' the 'cg' one,
    bit for bit, as in the JAX package."""
    c = _Case("super_resolution", 32, seed=3)
    ta, tkw = c.args()[1], c.kwargs(kind)[1]
    kw = dict(sigma_t=0.5, use_rtol_func=True, return_info=True)
    am, ai = TS.choose_solver(*ta, **tkw, method=alias, **kw)
    bm, bi = TS.choose_solver(*ta, **tkw, method=method, **kw)
    assert torch.equal(am, bm) and ai.niter == bi.niter


def test_choose_solver_coords_and_errors(monkeypatch):
    c = _Case("gaussian_blur", 32, seed=5)
    (_, ta), (_, tkw) = c.args(), c.kwargs("pixel")
    calls = []
    real = TS.deblur_mat_cg_fourier

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TS, "deblur_mat_cg_fourier", spy)
    out = {}
    for coords in ("auto", "fourier", "pixel"):
        n = len(calls)
        out[coords] = TS.choose_solver(*ta, **tkw, method="cg", sigma_t=0.3, cg_coords=coords)
        out[coords + "_fourier"] = len(calls) > n
    assert out["auto_fourier"] and out["fourier_fourier"] and not out["pixel_fourier"]
    _close(out["fourier"].numpy(), out["pixel"].numpy(), 1e-4)
    with pytest.raises(ValueError, match="cg_coords"):
        TS.choose_solver(*ta, **tkw, cg_coords="spectral")
    with pytest.raises(ValueError, match="unknown solver method"):
        TS.choose_solver(*ta, **tkw, method="cholesky")
    with pytest.raises(ValueError, match="return_u"):
        TS.choose_solver(*ta, **tkw, return_u=True)
    col = tget("colorization", device="cpu", in_shape=(1, 3, 32, 32))
    with pytest.raises(ValueError, match="no mat solver"):
        TS.choose_solver(col, ta[1][:, :1], ta[2], theta0_var=0.3)
