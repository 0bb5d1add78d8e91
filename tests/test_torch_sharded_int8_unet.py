"""The whole 32 px int8 UNet on a height shard (``UNetModel(cfg,
model_group=)`` with ``quant``), in a CPU gloo world of two ranks: ``int8``,
fused ``int8``, ``int8_static`` with one table and ``int8_calib``, forward
and the vjp of a weighted sum (remat on), against the unsharded port and
the JAX package's int8 UNet with ``spatial_partition`` over data:1,model:2
of the virtual mesh, at ``tests/test_torch_unet_int8.py``'s tolerances
(2e-3 of the largest |value| in f32, 5e-3 with the static table) on its
inputs; the vjp at 1e-2 of its scale (the cotangent is quantised at every
site, ``test_int8_fused_denoiser_vjp_matches_jax``'s limit); the calib
torso's abs-max of every site the whole batch's; every rank the same bits.
The int8 layers alone on a shard are ``tests/test_torch_sharded_int8.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from free_hunch_tpu.models.unet import UNetModel as JUNet
from free_hunch_tpu.parallel.mesh import make_mesh
from free_hunch_tpu_torch.models.convert import qscales_to_flax
from free_hunch_tpu_torch.ops.quant import _QuantSite
from tests._torch_parity import RES, one_thread, quant_pair, tiny_pair  # noqa: F401
from tests._torch_sharded import run_world

QUANTS = (("int8", False), ("int8", True), ("int8_static", False), ("int8_calib", False))


def _unet_inputs():
    """``tests/test_torch_unet_int8.py``'s inputs, on which it holds the
    unsharded port to the unsharded JAX model: int8 codes that flip between
    two frameworks or two summation orders move the output by a step of
    1/127 of a site's range, so a tolerance belongs to its input (on other
    draws the unsharded port itself can read several such steps off the
    unsharded JAX model). The dynamic torsos take its ``_inputs()`` at t =
    (10, 700); the static one its table and the raw UNet's input at the
    stage sigma 5 selects (stage 1)."""
    from tests._torch_parity import tiny_cfg_kwargs
    from tests.test_torch_unet_int8 import _inputs, _table, _unet_args
    from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
    rng = np.random.default_rng(6)
    _, _, tm = tiny_pair()
    tp0 = TPrecond(torch.nn.Identity(), img_resolution=RES, img_channels=3)
    _, table = _table(tm.cfg, tp0)
    xs, ts = _unet_args(tp0, _inputs(5) * 5.0, 5.0)
    return dict(cfg=tiny_cfg_kwargs(), sd=tm.state_dict(), quants=QUANTS,
                x=torch.as_tensor(_inputs()), t=torch.tensor([10.0, 700.0]),
                xt={"int8_static": (torch.as_tensor(xs), torch.as_tensor(ts))},
                w=torch.as_tensor(rng.normal(size=(2, 6, RES, RES)), dtype=torch.float32),
                table={k: float(v[1]) for k, v in table.items()})


@pytest.fixture(scope="module")
def unet_world(tmp_path_factory):
    inp = _unet_inputs()
    return inp, run_world("unet", 2, "data:1,model:2", inp, tmp_path_factory.mktemp("q8"))


def _xt(inp, quant):
    return inp["xt"].get(quant, (inp["x"], inp["t"]))


def _port(inp, quant, fused):
    _, _, tm = quant_pair(quant, fused=fused, remat=True)
    if quant == "int8_static":
        for n, m in tm.named_modules():
            if isinstance(m, _QuantSite):
                m.act_scale = torch.tensor(inp["table"][n])
    x, t = _xt(inp, quant)
    with torch.no_grad():
        y = tm(x, t)
    amax = {n: float(m.amax) for n, m in tm.named_modules()
            if isinstance(m, _QuantSite) and m.amax is not None}
    x = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((tm(x, t) * inp["w"]).sum(), x)
    return y, gx, amax


def _jax_sharded(inp, quant, fused, monkeypatch):
    """The JAX package's int8 UNet with spatial_partition over data:1,model:2
    of the virtual mesh, jitted."""
    jm, params, tm = quant_pair(quant, fused=fused)
    jm = JUNet(dataclasses.replace(jm.cfg, spatial_partition=("data", "model")))
    if quant == "int8_static":
        _, jtree = qscales_to_flax((np.ones(1, np.float32),
                                    {k: np.asarray([v], np.float32)
                                     for k, v in inp["table"].items()}), tm.cfg)
        params = {**params, "qscales": jax.tree.map(lambda a: jnp.asarray(a)[0], jtree)}
    mesh = make_mesh("data:1,model:2")
    rep = NamedSharding(mesh, P())
    if fused:
        monkeypatch.setenv("FREE_HUNCH_FUSED_GN_QUANT", "1")
    kw = dict(mutable=["qstats"]) if quant == "int8_calib" else {}
    x, t = _xt(inp, quant)
    with mesh:
        out = jax.jit(lambda p, a, b: jm.apply(p, a, b, **kw), in_shardings=(rep, rep, rep))(
            params, jnp.asarray(x.numpy()), jnp.asarray(t.numpy()))
    monkeypatch.delenv("FREE_HUNCH_FUSED_GN_QUANT", raising=False)
    return np.asarray(out[0] if quant == "int8_calib" else out)


@pytest.mark.parametrize("quant,fused", QUANTS,
                         ids=["int8", "int8_fused", "int8_static", "int8_calib"])
def test_sharded_int8_unet_matches_the_port_and_jax_sharded(unet_world, quant, fused,
                                                            monkeypatch):
    inp, outs = unet_world
    y, gx, amax = _port(inp, quant, fused)
    want_j = _jax_sharded(inp, quant, fused, monkeypatch)
    tol = 5e-3 if quant == "int8_static" else 2e-3
    for o in outs:
        r = o[(quant, fused)]
        assert float((r["y"] - y).abs().max()) <= tol * float(y.abs().max())
        np.testing.assert_allclose(r["y"].numpy(), want_j, rtol=0,
                                   atol=tol * np.abs(want_j).max())
        assert float((r["gx"] - gx).abs().max()) <= 1e-2 * float(gx.abs().max())
        assert torch.equal(r["y"], outs[0][(quant, fused)]["y"])
        assert torch.equal(r["gx"], outs[0][(quant, fused)]["gx"])
        if quant == "int8_calib":   # each site's abs-max of the whole batch
            assert sorted(r["amax"]) == sorted(amax)
            for k in amax:
                assert abs(r["amax"][k] - amax[k]) <= 1e-3 * amax[k], k
