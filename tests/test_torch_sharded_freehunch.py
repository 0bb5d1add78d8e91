"""Free Hunch with the model axis in the port: ``FreeHunch(model_group=)``
(the state's d over the model group) through the spatially sharded UNet,
3 EDM Heun steps, in CPU gloo worlds of ``data:1,model:2`` (two ranks) and
``data:2,model:2`` (four ranks: two model groups, each on its half of the
batch), against the JAX package's unsharded ``sample_scan`` on the same
inputs at ``tests/test_sharded_guided_step.py:93-107``'s rtol 2e-3 and
atol 2e-4, with its setup: the 32 px f32 UNet (``tiny_pair()``'s
weights), inpainting with a random mask (sigma_s 0.05), the identity
basis, capacity 8, ``cg_maxiter`` 8, the BFGS window 0.01-100 and the
clipped x0. The CG counts equal the JAX package's, and each rank's
``diag`` holds d / 2 columns. ``tests/test_torch_sharded_freehunch_variants.py``
runs ``algebra_dtype='float64'`` and ``guidance_gradient='covariance'``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.guidance import choose_conditioning_mechanism
from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu.operators import get_operator as jget_operator
from free_hunch_tpu.samplers import edm as jedm
from tests._torch_parity import RES, one_thread, tiny_cfg_kwargs, tiny_pair  # noqa: F401
from tests._torch_sharded import run_world

BATCH = 4
D = 3 * RES * RES
MECH = dict(cond_scaling=1.0, clip_x0_mean=True, init_denoiser_variance=1.0,
            init_noise_variance=100.0, data_dim=D, cov_capacity=8, cg_maxiter=8,
            space_step_update_lower_threshold=0.01, space_step_update_threshold=100.0,
            cg_coords="pixel")
CASES = {"vjp": {}, "f64": dict(algebra_dtype="float64"),
         "covariance": dict(guidance_gradient="covariance")}


@pytest.fixture(scope="module")
def setup():
    jm, params, tm = tiny_pair()
    pre = JPrecond(jm, img_resolution=RES, img_channels=3)
    op_kw = dict(name="inpainting", sigma_s=0.05, in_shape=(1, 3, RES, RES))
    jop = jget_operator(**op_kw, mask_opt={"mask_type": "random", "image_size": RES,
                                           "mask_prob_range": (0.2, 0.4)},
                        mask_key=jax.random.PRNGKey(1))
    xs, s0 = jedm.prepare_schedule(
        round_sigma=pre.round_sigma, net_sigma_min=pre.sigma_min, net_sigma_max=pre.sigma_max,
        num_steps=3, solver="heun", discretization="edm", schedule="linear", scaling="none")
    noise = jax.random.normal(jax.random.PRNGKey(2), (BATCH, 3, RES, RES))
    cond = jax.random.uniform(jax.random.PRNGKey(3), (BATCH, 3, RES, RES), minval=-1, maxval=1)
    y = jop.forward(cond, noiseless=True)
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    inputs = dict(cfg=tiny_cfg_kwargs(), sd=tm.state_dict(), xs=xs, s0=s0, noise=t(noise),
                  y=t(y), op=dict(op_kw, mask=t(jop.mask)))
    return pre, params, jop, inputs


def _jax_run(setup, knobs):
    pre, params, jop, inputs = setup
    mech = choose_conditioning_mechanism("online_covariance")(forward_operator=jop,
                                                              **MECH, **knobs)
    den = lambda x, s: pre.apply(params, x, s)  # noqa: E731
    x, traj, diag = jax.jit(lambda n, y: jedm.sample_scan(
        den, mech, n, y, inputs["xs"], jax.random.PRNGKey(4), sigma0_scaled=inputs["s0"],
        return_trajectory=True, collect_diagnostics=True))(
        jnp.asarray(inputs["noise"].numpy()), jnp.asarray(inputs["y"].numpy()))
    return np.asarray(traj), np.asarray(diag["cg_niter"])


def sharded_run(setup, tmp, name, mesh_shape):
    """Every rank's output of the case ``name`` under ``mesh_shape``."""
    world = {"data:1,model:2": 2, "data:2,model:2": 4}[mesh_shape]
    inputs = dict(setup[3], mech=dict(MECH, **CASES[name]), rows=BATCH * 2 // world)
    return run_world("freehunch", world, mesh_shape, inputs, tmp)


def check_against_jax(setup, outs, name, mesh_shape):
    traj, niter = _jax_run(setup, CASES[name])
    for o in outs:
        lo, hi = o["rows"]
        got = o["traj"].numpy()
        assert np.isfinite(got).all()
        for i in range(3):
            np.testing.assert_allclose(got[i], traj[i, lo:hi], rtol=2e-3, atol=2e-4,
                                       err_msg=f"{name} {mesh_shape} step {i}")
        np.testing.assert_array_equal(o["cg_niter"].numpy(), niter)
        assert o["diag"] == (hi - lo, D // 2) and o["Ut"] == (hi - lo, 8, D // 2)
    # the ranks of a model group agree bitwise
    by_group = {}
    for o in outs:
        by_group.setdefault(o["group"][0], []).append(o["traj"])
    for trajs in by_group.values():
        assert all(torch.equal(t, trajs[0]) for t in trajs)


@pytest.mark.parametrize("mesh_shape", ["data:1,model:2", "data:2,model:2"])
def test_sharded_slice_equals_jax_sample_scan(setup, tmp_path, mesh_shape):
    check_against_jax(setup, sharded_run(setup, tmp_path, "vjp", mesh_shape), "vjp",
                      mesh_shape)
