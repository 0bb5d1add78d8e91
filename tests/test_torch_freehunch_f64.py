"""Port parity for Free Hunch with ``algebra_dtype='float64'``: the
covariance state, the basis changes and the CG solve in float64 in both
packages (the JAX side under the test suite's ``jax_enable_x64``), the
denoiser and its vjp in float32.

The guided calls of tests/test_torch_freehunch.py, teacher-forced: before
each call the port's state is the JAX package's, in float64. Every solver
family runs: the deblur CG in pixel and in Fourier (complex128)
coordinates, super-resolution and inpainting, with the recycled CG start
and with the plain one. ``rtol_floor`` is lowered to 1e-10, which the f64
solve reaches, so each solve stops near its solution instead of at the f32
floor and the two packages' CG counts are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops import lowrank as jlr
from free_hunch_tpu_torch.guidance import mechanisms as tmech
from free_hunch_tpu_torch.ops import lowrank as tlr
from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_freehunch import (B, SHAPE, SIGMAS, _jdenoise, _mechs, _tdenoise,
                                        prior_dir)  # noqa: F401

F64 = np.float64


def _to_torch_state(js):
    c = js.cov
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return tmech.FreeHunchState(
        cov=tlr.LowRank(diag=t(c.diag), Ut=t(c.Ut), M=t(c.M),
                        k=torch.as_tensor(np.array(c.k), dtype=torch.int64)),
        prev_sigma=float(np.asarray(js.prev_sigma)), prev_x=t(js.prev_x),
        prev_mean=t(js.prev_mean), prev_u=t(js.prev_u), step=int(js.step),
        cg_niter=int(js.cg_niter), cg_resnorm=t(js.cg_resnorm).float(),
        cg_optfrac=t(js.cg_optfrac).float(), cg_host_syncs=0)


CASES = {
    "deblur_pixel_vjp_b": dict(op="gaussian_blur", cg_coords="pixel",
                               guidance_gradient="vjp", cg_warm_start="b"),
    "deblur_fourier_vjp_prev": dict(op="gaussian_blur", cg_coords="fourier",
                                    guidance_gradient="vjp", cg_warm_start="prev",
                                    denoiser_mean_error_threshold=1e9),
    "deblur_pixel_covariance_prev": dict(op="gaussian_blur", cg_coords="pixel",
                                         guidance_gradient="covariance", cg_warm_start="prev"),
    "super_resolution_vjp_prev": dict(op="super_resolution", guidance_gradient="vjp",
                                      cg_warm_start="prev", denoiser_mean_error_threshold=1e9),
    "inpainting_flat_prior_vjp_prev": dict(op="inpainting", guidance_gradient="vjp",
                                           cg_warm_start="prev",
                                           image_base_covariance="dct_diagonal_noinfo",
                                           denoiser_mean_error_threshold=1e9),
    "deblur_analytic_var_at_end": dict(op="gaussian_blur", cg_coords="pixel",
                                       guidance_gradient="vjp", cg_warm_start="prev",
                                       use_analytic_var_at_end=True, mle_sigma_thres=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_x0_mean_update_f64_teacher_forced_matches_jax(case, prior_dir):
    """Tolerances, set by the f64 algebra: what is left is the f32
    denoiser's, whose output and vjp differ between the two packages by
    an ulp or so (tanh), times sigma^2 in the update. Observed over the six
    cases, relative to each quantity's max |.|: x0 <= 5.6e-7, the state's
    action on a probe <= 1.5e-7, the recycled u <= 3.1e-7, CG counts equal.
    Held to 5e-6, 2e-6 and 3e-6 of the max |.|, against the f32 test's
    1e-4 + 5e-4, 1e-3 and 1e-4."""
    kw = dict(CASES[case])
    op = kw.pop("op")
    jm, tm = _mechs(prior_dir, op=op, algebra_dtype="float64", rtol_floor=1e-10, **kw)
    assert tm._adt == torch.float64
    rng = np.random.default_rng(0)
    y = rng.uniform(-1, 1, (B,) + tuple(tm.forward_operator.out_shape[1:])).astype(np.float32)
    js = jm.init_state(B, SHAPE[1:])
    ts0 = tm.init_state(B, SHAPE[1:])
    assert ts0.cov.diag.dtype == ts0.prev_x.dtype == ts0.prev_u.dtype == torch.float64
    assert js.cov.diag.dtype == jnp.float64
    step = jax.jit(lambda x, s, st: jm.x0_mean_update(_jdenoise, x, jnp.asarray(y), s, st))
    x = rng.normal(size=SHAPE).astype(np.float32) * SIGMAS[0]
    for i, sigma in enumerate(SIGMAS):
        s = float(np.float32(sigma))
        if i and SIGMAS[i - 1] == sigma:
            x = x + rng.normal(size=SHAPE).astype(np.float32) * 0.05 * s
        elif i:
            x = rng.normal(size=SHAPE).astype(np.float32) * s
        ts = _to_torch_state(js)
        jx0, js = step(jnp.asarray(x), jnp.float32(s), js)
        tx0, ts = tm.x0_mean_update(_tdenoise, torch.as_tensor(x), torch.as_tensor(y), s, ts)
        assert tx0.dtype == torch.float32 and ts.prev_u.dtype == torch.float64
        assert ts.cov.Ut.dtype == ts.prev_mean.dtype == torch.float64
        jx0 = np.asarray(jx0)
        np.testing.assert_allclose(tx0.numpy(), jx0, rtol=0, atol=5e-6 * np.abs(jx0).max(),
                                   err_msg=f"call {i} sigma {s}")
        probe = np.random.default_rng(7).normal(size=(B, ts.cov.diag.shape[-1]))
        want = np.asarray(jax.vmap(jlr.matvec)(js.cov, jnp.asarray(probe)))
        got = tlr.matvec(ts.cov, torch.as_tensor(probe)).numpy()
        np.testing.assert_array_equal(ts.cov.k.numpy(), np.asarray(js.cov.k))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
        ju = np.asarray(js.prev_u)
        assert ju.dtype == F64
        np.testing.assert_allclose(ts.prev_u.numpy(), ju, rtol=0,
                                   atol=3e-6 * max(np.abs(ju).max(), 1e-30))
        assert ts.cg_niter == int(js.cg_niter), (i, ts.cg_niter, int(js.cg_niter))


def test_unknown_algebra_dtype_raises_and_cov_partition_still_does():
    top = _mechs(op="gaussian_blur")[1].forward_operator
    with pytest.raises(ValueError, match="algebra_dtype"):
        tmech.FreeHunch(cond_scaling=1.0, forward_operator=top, algebra_dtype="float16")
    with pytest.raises(TypeError, match="cov_partition"):
        tmech.FreeHunch(cond_scaling=1.0, forward_operator=top, cov_partition=("data", None))
    assert tmech.FreeHunch(cond_scaling=1.0, forward_operator=top,
                           algebra_dtype="float32")._adt == torch.float32
