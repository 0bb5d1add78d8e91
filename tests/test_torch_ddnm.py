"""Port parity for the DDNM+ sampler (samplers/ddnm.py) against the JAX
package's ``free_hunch_tpu/samplers/ddnm.py``.

The whole sampler runs on ``tiny_pair()``'s 32 px UNet (identical f32
weights) in both packages, 4 steps, with one shared ``noise_seq`` for the
per-step draws. The JAX side runs with x64 off, as in production, so its
step scalars and DDNM+ factors are float32, as the port's are."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.operators import assets as jassets
from free_hunch_tpu.operators import svd as jsvd
from free_hunch_tpu.samplers import ddnm as jddnm
from free_hunch_tpu_torch.guidance import mechanisms as tmech
from free_hunch_tpu_torch.operators import svd as tsvd
from free_hunch_tpu_torch.samplers import ddnm as tddnm
from tests._torch_parity import one_thread, tiny_pair  # noqa: F401

RES = 32
B = 2
STEPS = 4
_MISSING = np.random.default_rng(5).choice(3 * RES * RES, 900, replace=False)


@pytest.mark.parametrize("T,length,repeat", [(5, 1, 1), (6, 1, 2), (10, 2, 3), (60, 1, 1),
                                             (8, 3, 2)])
def test_schedules_equal_jax(T, length, repeat):
    assert tddnm.get_schedule_jump(T, length, repeat) == jddnm.get_schedule_jump(T, length,
                                                                                 repeat)
    for got, want in zip(tddnm.ddnm_schedule(T, travel_length=length, travel_repeat=repeat),
                         jddnm.ddnm_schedule(T, travel_length=length, travel_repeat=repeat)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    steps = tddnm.ddnm_steps(T, travel_length=length, travel_repeat=repeat)
    at, at_next, fwd = jddnm.ddnm_schedule(T, travel_length=length, travel_repeat=repeat)
    np.testing.assert_array_equal([s["at"] for s in steps], at.astype(np.float32))
    np.testing.assert_array_equal([s["at_next"] for s in steps], at_next.astype(np.float32))
    assert [s["forward"] for s in steps] == fwd.tolist()
    if repeat > 1:
        assert not all(s["forward"] for s in steps)


def _operators(name):
    if name == "gaussian_blur":
        k = jassets.gaussian_blur_kernel()
        return jsvd.Deblurring(k, 3, RES), tsvd.Deblurring(k, 3, RES, device="cpu")
    if name == "super_resolution":
        return jsvd.SuperResolution(3, RES, 2), tsvd.SuperResolution(3, RES, 2, device="cpu")
    return jsvd.Inpainting(3, RES, _MISSING), tsvd.Inpainting(3, RES, _MISSING, device="cpu")


@pytest.mark.parametrize("op,eta,sigma_y,travel", [
    (op, eta, sigma_y, 1) for op in ("gaussian_blur", "super_resolution", "inpainting")
    for eta in (1.0, 0.85) for sigma_y in (0.0, 0.05)] + [("inpainting", 0.85, 0.05, 2)])
def test_ddnm_sample_matches_jax(op, eta, sigma_y, travel):
    """Tolerance: f32 UNets and operator matmuls round differently in the
    two packages (~1e-6 relative), and Eq. 12 divides epsilon's error by
    sqrt(alpha-bar), 7.8 at the first of 4 steps. Each iterate is held to
    2e-5 of its own max |x| (observed <= 4.7e-7 over the 13 cases)."""
    jm, params, tm = tiny_pair()
    rng = np.random.default_rng(7)
    cond = rng.uniform(-1, 1, (B, 3 * RES * RES)).astype(np.float32)
    noise = rng.normal(size=(B, 3, RES, RES)).astype(np.float32)
    n_steps = len(tddnm.ddnm_steps(STEPS, travel_repeat=travel))
    seq = rng.normal(size=(n_steps, B, 3, RES, RES)).astype(np.float32)
    kw = dict(num_steps=STEPS, sigma_y=sigma_y, eta=eta, travel_repeat=travel,
              return_trajectory=True)
    with jax.enable_x64(False):
        jop, top = _operators(op)
        y = np.asarray(jop.A(jnp.asarray(cond)))
        y = y + sigma_y * rng.normal(size=y.shape).astype(np.float32)
        jx, jtraj = jddnm.ddnm_sample(lambda x, t: jm.apply(params, x, t)[:, :3], jop,
                                      jnp.asarray(noise), jnp.asarray(y),
                                      noise_seq=jnp.asarray(seq), **kw)
        jtraj = np.asarray(jtraj)
    tx, ttraj = tddnm.ddnm_sample(lambda x, t: tm(x, t)[:, :3], top, torch.as_tensor(noise),
                                  torch.as_tensor(y), noise_seq=torch.as_tensor(seq), **kw)
    assert ttraj.shape == jtraj.shape == (n_steps, B, 3, RES, RES)
    assert torch.equal(tx, ttraj[-1]) and ttraj.dtype == torch.float32
    for i in range(n_steps):
        np.testing.assert_allclose(ttraj[i].numpy(), jtraj[i], rtol=0,
                                   atol=2e-5 * np.abs(jtraj[i]).max(), err_msg=f"step {i}")


def test_ddnm_sample_draws_from_its_generator():
    """Without noise_seq each step draws from the generator: the same seed
    gives the same run; [x0_last] is returned without the trajectory."""
    op = tsvd.SuperResolution(3, 16, 2, device="cpu")
    noise = torch.randn(1, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    y = op.A(torch.zeros(1, 3 * 16 * 16))
    runs = [tddnm.ddnm_sample(lambda x, t: 0.1 * x, op, noise, y, num_steps=3, sigma_y=0.05,
                              generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0][0], runs[1][0]) and not torch.equal(runs[0][0], runs[2][0])
    assert len(runs[0][1]) == 1 and runs[0][1][0].shape == noise.shape


@pytest.mark.parametrize("kwargs,shape", [
    ({"name": "gaussian_blur"}, (B, 3, RES, RES)),
    ({"name": "super_resolution", "scale_factor": 2}, (B, 3, RES // 2, RES // 2)),
    ({"name": "inpainting", "mask_opt": {"mask_type": "random",
                                          "mask_prob_range": (0.2, 0.4)}},
     (B, 3, RES, RES))])
def test_conditional_sampler_outputs(kwargs, shape):
    rng = np.random.default_rng(8)
    cond = torch.as_tensor(rng.uniform(-1, 1, (B, 3, RES, RES)), dtype=torch.float32)
    noise = torch.as_tensor(rng.normal(size=(B, 3, RES, RES)), dtype=torch.float32)
    x, x_all, y_out = tddnm.ddnm_conditional_sampler(
        lambda x, t: 0.1 * x, noise, cond, kwargs, {"sigma": 0.05}, num_steps=3,
        generator=torch.Generator().manual_seed(1),
        measurement_generator=torch.Generator().manual_seed(2),
        mask_generator=torch.Generator().manual_seed(3), ignored_edm_option=1.0)
    assert x.shape == noise.shape and bool(torch.isfinite(x).all())
    assert tuple(y_out.shape) == shape and len(x_all) == 1
    # the measurement noise is the measurement generator's first draw
    op = tddnm.build_svd_operator(kwargs, RES, generator=torch.Generator().manual_seed(3),
                                  device="cpu")
    y = op.A(cond.reshape(B, -1))
    y = y + 0.05 * torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    want = (op.A_with_zeros(cond.reshape(B, -1)).reshape(cond.shape)
            if kwargs["name"] == "inpainting" else y.reshape(shape))
    assert torch.equal(y_out, want)


def test_motion_blur_and_unknown_operators_raise():
    with pytest.raises(NotImplementedError, match="Motion blur"):
        tddnm.build_svd_operator({"name": "motion_blur"}, RES, device="cpu")
    with pytest.raises(ValueError, match="not supported for DDNM"):
        tddnm.build_svd_operator({"name": "phase_retrieval"}, RES, device="cpu")


def test_factory_names_the_ddnm_sampler():
    with pytest.raises(ValueError, match=r"free_hunch_tpu_torch\.samplers\.ddnm"):
        tmech.choose_conditioning_mechanism("ddnm")
    with pytest.raises(ValueError, match=r"free_hunch_tpu\.samplers\.ddnm"):
        from free_hunch_tpu.guidance import mechanisms as jmech
        jmech.choose_conditioning_mechanism("ddnm")
