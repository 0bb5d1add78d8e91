"""The int8 torso on a height shard, in CPU gloo worlds of two and three
ranks (three: uneven shards of 3, 3 and 2 rows).

* The unfused int8 layers on a shard (``ops/quant.py``: the dynamic
  per-sample abs-max max-merged over the group, one-row halos of the int8
  codes at a 3x3 site, K3's plain twin with height padding 0): codes,
  scales, outputs and the gradients of a weighted sum bitwise equal to the
  unsharded port's (an abs-max is order-free and the int32 sums are exact).
* K2's plain twin on a shard (``gn_silu_quant_sharded_plain``) and the
  fused route (``QuantConv(x, gn=...)``) against the unsharded port and the
  JAX package's ``gn_silu_quant_reference`` and ``gn_quant_conv``: the
  scale within 1e-6 relative, a code off by at most one and only where y /
  scale lies within rounding of a half-integer (the merged statistics sum
  in another order), the fused output within 2e-3 of its scale.

The whole int8 UNet on a shard is ``tests/test_torch_sharded_int8_unet.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops import pallas_gn_quant as jgq
from free_hunch_tpu.ops import quant as jq
from free_hunch_tpu_torch.ops import gn_quant as tgq
from free_hunch_tpu_torch.ops.quant import QuantConv, QuantDense, _quantize_act
from tests._torch_parity import one_thread  # noqa: F401
from tests._torch_sharded import run_world

CIN, COUT, H, W = 64, 32, 8, 8


def _normal(rng, shape, scale=1.0):
    return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32)


@pytest.fixture(scope="module")
def layer_inputs():
    rng = np.random.default_rng(11)
    inp = dict(x=_normal(rng, (2, CIN, H, W), 2.0) + 0.5, cout=COUT,
               static_scale=torch.tensor(0.06),
               gamma_nc=_normal(rng, (2, CIN), 0.2) + 1, beta_nc=_normal(rng, (2, CIN), 0.2),
               w_dense=_normal(rng, (2, H * W, COUT)))
    for name, k in (("conv3", 3), ("conv3_static", 3), ("conv1", 1), ("fused", 3)):
        inp["w_" + name] = _normal(rng, (2, COUT, H, W))
    torch.manual_seed(0)
    inp["sd_conv3"] = QuantConv(CIN, COUT, 3, dtype=torch.float32).state_dict()
    inp["sd_conv3_static"] = inp["sd_conv3"]
    inp["sd_conv1"] = QuantConv(CIN, COUT, 1, dtype=torch.float32).state_dict()
    inp["sd_dense"] = QuantDense(CIN, COUT, dtype=torch.float32).state_dict()
    return inp


@pytest.fixture(scope="module", params=[2, 3])
def layer_world(request, layer_inputs, tmp_path_factory):
    m = request.param
    return m, run_world("int8", m, f"data:1,model:{m}", layer_inputs,
                        tmp_path_factory.mktemp(f"int8_{m}"))


def _unsharded(inp, name):
    """The unsharded port's output and gradient of one layer of the world."""
    x = inp["x"].clone().requires_grad_(True)
    if name == "dense":
        m = QuantDense(CIN, COUT, dtype=torch.float32)
        m.load_state_dict(inp["sd_dense"])
        y = m.requires_grad_(False)(x.permute(0, 2, 3, 1).reshape(2, -1, CIN))
        (gx,) = torch.autograd.grad((y * inp["w_dense"]).sum(), x)
        return y.detach(), gx.permute(0, 2, 3, 1).reshape(2, -1, CIN)
    k = 1 if name == "conv1" else 3
    m = QuantConv(CIN, COUT, k, mode="static" if name == "conv3_static" else "dynamic",
                  dtype=torch.float32)
    m.load_state_dict(inp["sd_" + ("conv3" if name == "fused" else name)])
    if name == "conv3_static":
        m.act_scale = inp["static_scale"]
    m.requires_grad_(False)
    y = m(x, gn=(inp["gamma_nc"], inp["beta_nc"])) if name == "fused" else m(x)
    (gx,) = torch.autograd.grad((y * inp["w_" + name]).sum(), x)
    return y.detach(), gx


def test_sharded_quantize_act_is_the_unsharded_one(layer_world, layer_inputs):
    m, outs = layer_world
    xq, scale = _quantize_act(layer_inputs["x"].permute(0, 2, 3, 1))
    for o in outs:
        assert torch.equal(o["act"][0], xq) and torch.equal(o["act"][1], scale)


@pytest.mark.parametrize("name", ["conv3", "conv3_static", "conv1", "dense"])
def test_sharded_int8_layers_are_bitwise_the_unsharded_port(layer_world, layer_inputs, name):
    _, outs = layer_world
    y, gx = _unsharded(layer_inputs, name)
    for o in outs:
        got_y, got_gx = o[name]
        assert torch.equal(got_y, y), float((got_y - y).abs().max())
        assert torch.equal(got_gx, gx), float((got_gx - gx).abs().max())


def _codes_off_only_at_ties(got, want, ratio):
    """Codes off by at most one, and only where the unsharded y / scale
    lies within ``ratio`` of a half-integer."""
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1
    frac = (ratio - torch.floor(ratio)).sub(0.5).abs()
    assert bool((frac[d > 0] < 1e-3).all()), frac[d > 0]


def test_sharded_gn_silu_quant_plain_matches_the_port_and_jax(layer_world, layer_inputs):
    _, outs = layer_world
    inp = layer_inputs
    x = inp["x"].permute(0, 2, 3, 1).contiguous()
    xq, scale = tgq.gn_silu_quant_plain(x, inp["gamma_nc"], inp["beta_nc"], 32, 1e-5)
    ratio = tgq._gn_silu_ref_f32(x, inp["gamma_nc"], inp["beta_nc"], 32, 1e-5) / scale
    jxq, jscale = jax.jit(jgq.gn_silu_quant_reference, static_argnums=(3, 4))(
        *(jnp.asarray(t.numpy()) for t in (x, inp["gamma_nc"], inp["beta_nc"])), 32, 1e-5)
    for o in outs:
        gxq, gscale = o["gnq"]
        for want in (scale, torch.as_tensor(np.array(jscale))):
            assert float(((gscale - want).abs() / want).max()) <= 1e-6
        _codes_off_only_at_ties(gxq, xq, ratio)
        _codes_off_only_at_ties(gxq, torch.as_tensor(np.array(jxq)), ratio)


def test_sharded_fused_route_matches_the_port_and_jax(layer_world, layer_inputs):
    _, outs = layer_world
    inp = layer_inputs
    y, gx = _unsharded(inp, "fused")
    w = QuantConv(CIN, COUT, 3, dtype=torch.float32)
    w.load_state_dict(inp["sd_conv3"])
    x = jnp.asarray(inp["x"].permute(0, 2, 3, 1).numpy())
    jy = jq.gn_quant_conv(x, jnp.asarray(inp["gamma_nc"].numpy()),
                          jnp.asarray(inp["beta_nc"].numpy()),
                          jnp.asarray(w._master().detach().numpy()), 1, 32, 1e-5)
    jy = (torch.as_tensor(np.array(jy)) + w.bias.detach()).permute(0, 3, 1, 2)
    for o in outs:
        got_y, got_gx = o["fused"]
        for want in (y, jy):
            assert float((got_y - want).abs().max()) <= 2e-3 * float(want.abs().max())
        assert float((got_gx - gx).abs().max()) <= 1e-4 * float(gx.abs().max())
