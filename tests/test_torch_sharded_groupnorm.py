"""GroupNorm(+SiLU) on a height shard (``ops/groupnorm.py::
groupnorm_silu_sharded``: on the CPU its plain version, two centred
all_reduces) in CPU gloo worlds of two and four ranks, forward and
backward, against the port's unsharded plain version and the JAX
package's ``_reference`` (``free_hunch_tpu/ops/pallas_groupnorm.py:38``);
``decide`` across ranks; and the model axis's raises, which need no world:
a ragged height, the int8 torso, a model size that does not divide the
world; and a model group of one rank, which leaves the UNet and the
Free Hunch state whole."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops.pallas_groupnorm import _reference as jreference
from free_hunch_tpu_torch.models.unet import (GroupNorm32, UNetConfig, UNetModel,
                                              check_shard_heights)
from free_hunch_tpu_torch.ops.groupnorm import groupnorm_silu_plain
from free_hunch_tpu_torch.parallel import mesh
from tests._torch_parity import one_thread, tiny_cfg_kwargs  # noqa: F401
from tests._torch_sharded import run_world

SHAPE = (2, 8, 4, 64)   # (N, H, W, C): H shards over 2 and 4 ranks


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    rng = np.random.default_rng(3)
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    inputs = dict(x=f(*SHAPE) * 2.0 + 0.5, gamma=1.0 + 0.1 * f(SHAPE[-1]),
                  beta=0.1 * f(SHAPE[-1]), w=f(*SHAPE))
    m = request.param
    return m, inputs, run_world("gn", m, f"data:1,model:{m}", inputs,
                                tmp_path_factory.mktemp(f"gn{m}"))


@pytest.mark.parametrize("silu", [True, False])
def test_sharded_forward_and_backward_equal_the_unsharded_port(world, silu):
    _, inputs, outs = world
    x = inputs["x"].clone().requires_grad_(True)
    g = inputs["gamma"].clone().requires_grad_(True)
    b = inputs["beta"].clone().requires_grad_(True)
    y = groupnorm_silu_plain(x, g, b, 32, 1e-5, silu)
    gx, gg, gb = torch.autograd.grad((y * inputs["w"]).sum(), (x, g, b))
    for o in outs:
        r = o[silu]
        np.testing.assert_allclose(r["y"].numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["gx"].numpy(), gx.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["gg"].numpy(), gg.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["gb"].numpy(), gb.numpy(), rtol=1e-4, atol=1e-4)
        assert torch.equal(r["y"], outs[0][silu]["y"])


@pytest.mark.parametrize("silu", [True, False])
def test_sharded_forward_and_backward_equal_jax_reference(world, silu):
    _, inputs, outs = world
    args = [jnp.asarray(inputs[k].numpy()) for k in ("x", "gamma", "beta")]
    f = lambda x, g, b: jreference(x, g, b, 32, 1e-5, silu)  # noqa: E731
    y, pull = jax.vjp(f, *args)
    gx, gg, gb = pull(jnp.asarray(inputs["w"].numpy()))
    for o in outs:
        r = o[silu]
        np.testing.assert_allclose(r["y"].numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["gx"].numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["gg"].numpy(), np.asarray(gg), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["gb"].numpy(), np.asarray(gb), rtol=1e-4, atol=1e-4)


def test_decide_agrees_or_raises_on_every_rank(world):
    m, _, outs = world
    assert [o["diverged_raises"] for o in outs] == [True] * m
    assert [o["agreed"] for o in outs] == [True] * m
    assert [o["group"] for o in outs] == [(0, 1, r, m) for r in range(m)]


@pytest.mark.parametrize("height,m,level", [(32, 3, 0), (32, 32, 0), (32, 16, 1), (8, 8, 0)])
def test_a_ragged_height_raises_naming_the_level(height, m, level):
    cfg = UNetConfig(**dict(tiny_cfg_kwargs(), channel_mult=(1, 2, 2)), dtype=torch.float32,
                     remat=False)
    with pytest.raises(ValueError, match=f"level {level}.*item 15b"):
        check_shard_heights(cfg, height, m)
    check_shard_heights(cfg, 32, 4)  # 32 and 16 rows: shards of 8 and 4


def test_a_ragged_height_raises_in_the_forward():
    cfg = UNetConfig(**tiny_cfg_kwargs(), dtype=torch.float32, remat=False)
    group = mesh.ModelGroup(data_index=0, data_size=1, model_index=0, model_size=3,
                            ranks=(0, 1, 2))
    with pytest.raises(ValueError, match="level 0.*item 15b"):
        UNetModel(cfg, model_group=group)(torch.zeros(1, 3, 32, 32), torch.zeros(1))


def test_int8_with_a_model_axis_raises():
    group = mesh.ModelGroup(data_index=0, data_size=1, model_index=0, model_size=2,
                            ranks=(0, 1))
    with pytest.raises(ValueError, match="item 15b"):
        UNetModel(UNetConfig(**tiny_cfg_kwargs(), quant="int8"), model_group=group)


@pytest.mark.parametrize("spec,world", [("data:1,model:2", 3), ("model:4", 6),
                                        ("data:3,model:2", 4)])
def test_a_model_axis_that_does_not_fit_the_world_raises(spec, world):
    with pytest.raises(ValueError, match="model axis"):
        mesh.check_mesh_shape(spec, world)


@pytest.mark.parametrize("spec,world,want", [("data:1,model:2", 2, (1, 2)),
                                             ("data:-1,model:2", 8, (4, 2)),
                                             ("data:2,model:2", 4, (2, 2)),
                                             ("data:1", 3, (3, 1))])
def test_check_mesh_shape_fills_the_data_axis_from_the_world(spec, world, want):
    assert mesh.check_mesh_shape(spec, world) == {"data": want[0], "model": want[1]}


@pytest.mark.parametrize("group", [None, mesh.ModelGroup(0, 1, 0, 1, (0,))])
def test_a_model_group_of_one_rank_leaves_the_model_and_state_whole(group):
    from free_hunch_tpu_torch.guidance.mechanisms import FreeHunch
    from free_hunch_tpu_torch.operators import get_operator
    cfg = UNetConfig(**tiny_cfg_kwargs(), dtype=torch.float32, remat=False)
    model = UNetModel(cfg, model_group=group)
    assert model.mg is None
    assert all(m.mg is None for m in model.modules() if isinstance(m, GroupNorm32))
    op = get_operator("gaussian_blur", in_shape=(1, 3, 32, 32), device="cpu")
    mech = FreeHunch(cond_scaling=1.0, forward_operator=op, model_group=group)
    assert mech.init_state(1, (3, 32, 32)).cov.diag.shape == (1, 3 * 32 * 32)
