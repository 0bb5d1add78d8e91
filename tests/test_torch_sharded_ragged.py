"""Ragged height and d shards (``parallel/mesh.py::plan_shards`` and
``split_sizes``), in CPU gloo worlds where the model size divides neither
the height nor d.

* The 32 px f32 UNet of ``tests/test_torch_sharded_unet.py`` at
  ``model:3`` (32 rows as 12, 10, 10; 16 as 6, 5, 5), remat off and on, and
  remat on (the path of the guidance), and the 8 px net of
  ``tests/test_sharded_unet.py:128-143`` (remat off) at ``model:5``
  (its deepest level's 4 rows as 1, 1, 1, 1, 0: the last rank holds no
  rows at any level), forward and vjp against the unsharded port within
  2e-5 (``MP_ERR``) and against the JAX package's model with
  ``spatial_partition`` on the virtual mesh (GSPMD pads the ragged shards)
  at ``UNET_TOL``; every rank gets the same bits. The fused int8 torso at
  ``model:3`` against the unsharded port at 2e-3 of its largest |value|, on
  ``tests/test_torch_unet_int8.py``'s input, as
  ``tests/test_torch_sharded_int8_unet.py`` holds it at ``model:2`` (a
  flipped int8 code moves the output by a step of 1/127 of a site's range,
  and the summation orders of the shards' statistics can flip one).
* The d-sharded covariance state at ``model:5`` over d = 3072 (blocks of
  615, 615, 614, 614, 614): the matvec against the JAX package's
  ``sharded_matvec`` on the state padded to 3075 (its ``shard_map`` takes
  only even blocks, as GSPMD pads a ragged one; the padding adds zeros to
  every sum), and every ``reduce``-taking function against the unsharded
  port: rtol 1e-5 and an atol of 5e-5 of the largest |value| (the f32 sums
  over 3072 entries run in another order, and ``compress``'s Cholesky of
  the jittered Gram matrix amplifies that: the unsharded port moves by the
  same order when the Gram matrix alone is summed in blocks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from free_hunch_tpu.models.unet import UNetConfig as JConfig
from free_hunch_tpu.models.unet import UNetModel as JUNet
from free_hunch_tpu.ops import lowrank as jlr
from free_hunch_tpu.parallel.mesh import make_mesh
from free_hunch_tpu.parallel.sharded_cov import shard_state as jshard_state
from free_hunch_tpu.parallel.sharded_cov import sharded_matvec as jsharded_matvec
from free_hunch_tpu_torch.guidance import covariance as cv
from free_hunch_tpu_torch.models.convert import state_dict_from_flax
from free_hunch_tpu_torch.models.unet import UNetConfig, UNetModel
from free_hunch_tpu_torch.ops import lowrank as lr
from free_hunch_tpu_torch.parallel.mesh import split_sizes
from tests._torch_parity import (_randomize_zero_leaves, one_thread,  # noqa: F401
                                 quant_pair, tiny_cfg_kwargs, tiny_pair)
from tests._torch_sharded import run_world
from tests.test_torch_sharded_unet import MP_ERR
from tests.test_torch_unet import UNET_TOL


def _net8():
    """The 8 px net of tests/test_sharded_unet.py:128-143 in both packages,
    with the same random weights."""
    kw = dict(image_size=8, in_channels=3, model_channels=32, out_channels=6,
              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
              num_head_channels=16)
    jm = JUNet(JConfig(**kw, dtype=jnp.float32, remat=False))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 8), jnp.float32),
                              jnp.zeros((1,), jnp.float32))
    params = jax.tree.map(jnp.asarray, _randomize_zero_leaves(params))
    tm = UNetModel(UNetConfig(**kw, dtype=torch.float32, remat=False))
    tm.load_state_dict(state_dict_from_flax(params, tm.cfg))
    return kw, jm, params, tm.eval().requires_grad_(False)


CASES = {"32px_model3": 3, "8px_model5": 5}


_WORLDS: dict = {}


def _world(case, tmp_path_factory):
    """(case, inputs, the world's outputs, the unsharded port's model, the
    JAX model and params), run once a case."""
    if case not in _WORLDS:
        _WORLDS[case] = _run_world(case, tmp_path_factory)
    return _WORLDS[case]


@pytest.fixture(scope="module", params=list(CASES))
def ragged(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def ragged32(tmp_path_factory):
    return _world("32px_model3", tmp_path_factory)


def _run_world(case, tmp_path_factory):
    m = CASES[case]
    rng = np.random.default_rng(7)
    if case == "32px_model3":
        jm, params, tm = tiny_pair()
        kw, res, remats, quants = tiny_cfg_kwargs(), 32, (True,), (("int8", True),)
        from tests.test_torch_unet_int8 import _inputs
    else:
        kw, jm, params, tm = _net8()
        res, remats, quants = 8, (False,), ()
    inputs = dict(cfg=kw, sd=tm.state_dict(), remats=remats, quants=quants,
                  x=torch.as_tensor(rng.normal(size=(2, 3, res, res)), dtype=torch.float32),
                  t=torch.tensor([10.0, 700.0]),
                  w=torch.as_tensor(rng.normal(size=(2, 6, res, res)), dtype=torch.float32))
    if quants:
        inputs["xt"] = {"int8": (torch.as_tensor(_inputs()), inputs["t"])}
    outs = run_world("unet", m, f"data:1,model:{m}", inputs, tmp_path_factory.mktemp(case))
    return case, inputs, outs, tm, jm, params


def _fwd_vjp(model, inputs):
    x = inputs["x"].clone().requires_grad_(True)
    y = model(x, inputs["t"])
    (gx,) = torch.autograd.grad((y * inputs["w"]).sum(), x)
    return y.detach(), gx


def test_ragged_unet_forward_and_vjp_equal_the_unsharded_port(ragged):
    _, inputs, outs, tm, _, _ = ragged
    y, gx = _fwd_vjp(tm, inputs)
    for o in outs:
        for remat in inputs["remats"]:
            assert float((o[remat]["y"] - y).abs().max()) < MP_ERR
            assert float((o[remat]["gx"] - gx).abs().max()) < MP_ERR


def test_ragged_unet_forward_and_vjp_equal_jax_sharded(ragged):
    case, inputs, outs, _, jm, params = ragged
    m = CASES[case]
    js = JUNet(dataclasses.replace(jm.cfg, spatial_partition=("data", "model")))
    t = jnp.asarray(inputs["t"].numpy())
    mesh = make_mesh(f"data:1,model:{m}")
    rep = NamedSharding(mesh, P())

    def fwd_vjp(x, w):
        y, pull = jax.vjp(lambda a: js.apply(params, a, t), x)
        return y, pull(w)[0]

    with mesh:
        y, gx = jax.jit(fwd_vjp, in_shardings=(rep, rep))(
            jnp.asarray(inputs["x"].numpy()), jnp.asarray(inputs["w"].numpy()))
    for o in outs:
        for remat in inputs["remats"]:
            np.testing.assert_allclose(o[remat]["y"].numpy(), np.asarray(y), **UNET_TOL)
            np.testing.assert_allclose(o[remat]["gx"].numpy(), np.asarray(gx), **UNET_TOL)


def test_every_rank_of_a_ragged_group_gets_the_same_bits(ragged):
    case, inputs, outs, _, _, _ = ragged
    m = CASES[case]
    assert [o["group"] for o in outs] == [(0, 1, r, m) for r in range(m)]
    for key in list(inputs["remats"]) + list(inputs["quants"]):
        for o in outs[1:]:
            assert torch.equal(o[key]["y"], outs[0][key]["y"])
            assert torch.equal(o[key]["gx"], outs[0][key]["gx"])


def test_the_fused_int8_torso_on_ragged_shards_equals_the_unsharded_port(ragged32):
    _, inputs, outs, _, _, _ = ragged32
    _, _, tm = quant_pair("int8", fused=True, remat=True)
    x, t = inputs["xt"]["int8"]
    y, gx = _fwd_vjp(tm, dict(inputs, x=x, t=t))
    for o in outs:
        r = o[("int8", True)]
        assert float((r["y"] - y).abs().max()) <= 2e-3 * float(y.abs().max())
        assert float((r["gx"] - gx).abs().max()) <= 1e-2 * float(gx.abs().max())


# -- the d-sharded state over d = 3072 at model:5 -------------------------------

B, K, D, M5 = 2, 6, 3072, 5


@pytest.fixture(scope="module")
def cov5(tmp_path_factory):
    rng = np.random.default_rng(8)
    diag = torch.as_tensor(rng.uniform(0.5, 2.0, (B, D)), dtype=torch.float32)
    cov = lr.init(diag, K)
    vec = lambda: torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32)  # noqa: E731
    for _ in range(2):
        cov = lr.append_pair(cov, vec(), torch.full((B,), 0.5), vec(), torch.full((B,), -0.3))
    x = vec()
    inputs = dict(cov=tuple(cov), v=vec(), a=vec(), b=vec(), x=x, x2=x + 0.1 * vec(),
                  m=vec(), m2=vec(), wa=torch.tensor([0.7, 0.2]), wb=torch.tensor([-0.1, 0.4]),
                  jax_cases=[])
    return inputs, run_world("cov", M5, f"data:1,model:{M5}", inputs,
                             tmp_path_factory.mktemp("cov5"))


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=5e-5 * scale, err_msg=what)


def test_each_rank_holds_its_ragged_block_of_d(cov5):
    _, outs = cov5
    sizes = split_sizes(D, M5)
    assert sizes == (615, 615, 614, 614, 614)
    for r, o in enumerate(outs):
        assert o["diag_cols"] == sizes[r]
        assert o["block"].tolist() == [sum(sizes[:r]), sum(sizes[:r + 1])]


def test_ragged_matvec_equals_jax_sharded_matvec_on_the_padded_state(cov5):
    inputs, outs = cov5
    diag, ut, mm, _ = inputs["cov"]
    pad = -D % M5
    z = lambda a: np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), a.dtype)], -1)  # noqa
    mesh = make_mesh(f"model:{M5}")
    fn = jax.jit(jsharded_matvec(mesh))
    for b in range(B):
        rep = jlr.LowRank(diag=jnp.asarray(z(diag[b].numpy())), Ut=jnp.asarray(z(ut[b].numpy())),
                          M=jnp.asarray(mm[b].numpy()), k=jnp.asarray(K))
        sh = jshard_state(rep, mesh)
        v = jax.device_put(jnp.asarray(z(inputs["v"][b].numpy())),
                           NamedSharding(mesh, P("model")))
        want = np.asarray(fn(sh.diag, sh.Ut, sh.M, v))[:D]
        for o in outs:
            _close(o["matvec"][b].numpy(), want, "matvec")


@pytest.mark.parametrize("name", ["matvec", "inverse", "compress", "append", "time_update",
                                  "space_update"])
def test_ragged_reduce_taking_functions_equal_the_unsharded_port(cov5, name):
    inputs, outs = cov5
    cov = lr.LowRank(*inputs["cov"])
    if name == "matvec":
        for o in outs:
            _close(o["matvec"].numpy(), lr.matvec(cov, inputs["v"]).numpy(), name)
        return
    want = {"inverse": lambda: lr.inverse(cov),
            "compress": lambda: lr.compress(cov, 3),
            "append": lambda: lr.append_pair(cov, inputs["a"], inputs["wa"], inputs["b"],
                                             inputs["wb"]),
            "time_update": lambda: cv.time_update(cov, 6.0, 2.5),
            "space_update": lambda: cv.space_update(cov, 2.5, inputs["x"], inputs["x2"],
                                                    inputs["m"], inputs["m2"])}[name]()
    probe = torch.as_tensor(np.random.default_rng(5).normal(size=(B, D)), dtype=torch.float32)
    for o in outs:
        got = o[name]
        assert torch.equal(got["k"], want.k), name
        _close(got["diag"].numpy(), want.diag.numpy(), f"{name} diag")
        g = lr.matvec(lr.LowRank(got["diag"], got["Ut"], got["M"], got["k"]), probe)
        _close(g.numpy(), lr.matvec(want, probe).numpy(), f"{name} matvec")
