"""The spatially sharded UNet of the port (``UNetModel(model_group=)``:
height over the model group, one-row halos, GroupNorm statistics merged
across ranks, attention over gathered keys and values, the output gathered
whole) in CPU gloo worlds of two and four ranks, on the 32 px f32 config
of ``tests/test_sharded_unet.py:36-41`` with ``tiny_pair()``'s weights,
``remat`` off and on:

* forward and vjp against the port's unsharded model: max abs error below
  2e-5 (``tests/test_multiprocess.py:76``'s limit for the JAX package's
  cross-process sharded UNet);
* forward and vjp against the JAX package's at ``UNET_TOL``
  (``tests/test_torch_unet.py``), the weights carried across by the
  existing bridge (``models/convert.py``);
* every rank of the group gets the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import RES, one_thread, tiny_cfg_kwargs, tiny_pair  # noqa: F401
from tests._torch_sharded import run_world
from tests.test_torch_unet import UNET_TOL

MP_ERR = 2e-5


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    _, _, tm = tiny_pair()
    return dict(cfg=tiny_cfg_kwargs(), sd=tm.state_dict(), remats=(False, True),
                x=torch.as_tensor(rng.normal(size=(2, 3, RES, RES)), dtype=torch.float32),
                t=torch.tensor([10.0, 700.0]),
                w=torch.as_tensor(rng.normal(size=(2, 6, RES, RES)), dtype=torch.float32))


@pytest.fixture(scope="module", params=[2, 4])
def world(request, inputs, tmp_path_factory):
    m = request.param
    return m, run_world("unet", m, f"data:1,model:{m}", inputs,
                        tmp_path_factory.mktemp(f"unet{m}"))


@pytest.fixture(scope="module")
def unsharded(inputs):
    _, _, tm = tiny_pair()
    x = inputs["x"].clone().requires_grad_(True)
    y = tm(x, inputs["t"])
    (gx,) = torch.autograd.grad((y * inputs["w"]).sum(), x)
    return y.detach(), gx


@pytest.fixture(scope="module")
def jax_ref(inputs):
    jm, params, _ = tiny_pair()
    f = lambda x: jm.apply(params, x, jnp.asarray(inputs["t"].numpy()))  # noqa: E731
    y, pull = jax.vjp(f, jnp.asarray(inputs["x"].numpy()))
    (gx,) = pull(jnp.asarray(inputs["w"].numpy()))
    return np.asarray(y), np.asarray(gx)


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_forward_and_vjp_equal_the_unsharded_port(world, unsharded, remat):
    _, outs = world
    y, gx = unsharded
    for o in outs:
        assert float((o[remat]["y"] - y).abs().max()) < MP_ERR
        assert float((o[remat]["gx"] - gx).abs().max()) < MP_ERR


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_forward_and_vjp_equal_jax(world, jax_ref, remat):
    _, outs = world
    y, gx = jax_ref
    for o in outs:
        np.testing.assert_allclose(o[remat]["y"].numpy(), y, **UNET_TOL)
        np.testing.assert_allclose(o[remat]["gx"].numpy(), gx, **UNET_TOL)


def test_every_rank_of_the_group_gets_the_same_bits(world):
    m, outs = world
    assert [o["group"] for o in outs] == [(0, 1, r, m) for r in range(m)]
    for remat in (False, True):
        for o in outs[1:]:
            assert torch.equal(o[remat]["y"], outs[0][remat]["y"])
            assert torch.equal(o[remat]["gx"], outs[0][remat]["gx"])
