"""The d-sharded covariance algebra of the port (``parallel/sharded_cov.py``
and the ``reduce`` of ``ops/lowrank.py`` and ``guidance/covariance.py``) in
a CPU gloo world of four ranks (``data:1,model:4``).

* the sharded matvec (``lowrank.matvec`` on ``shard_state``'s block with
  ``model_reduce``, as Free Hunch runs it) against the JAX package's own
  ``sharded_matvec`` on the
  conftest's 8-device virtual mesh, ``model:4`` and ``data:2,model:4``, on
  the states ``tests/test_sharded_cov.py`` builds, at its rtol 1e-5 and
  atol 1e-6.
* Every ``reduce``-taking function, its sharded result gathered, against
  the unsharded port on the same state: the sums over d run in another
  order, so f32 agreement is to a few ulps of the largest term; ``k`` and
  every host decision (the compress test) equal.
* Each rank holds d / 4 columns of ``diag`` and ``Ut``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from free_hunch_tpu.ops import lowrank as jlr
from free_hunch_tpu.parallel.mesh import make_mesh
from free_hunch_tpu.parallel.sharded_cov import shard_state as jshard_state
from free_hunch_tpu.parallel.sharded_cov import sharded_matvec as jsharded_matvec
from free_hunch_tpu_torch.guidance import covariance as cv
from free_hunch_tpu_torch.ops import lowrank as lr
from tests._torch_parity import one_thread  # noqa: F401
from tests._torch_sharded import run_world

B, K, D = 2, 6, 192
WORLD = 4


def _state(rng):
    diag = torch.as_tensor(rng.uniform(0.5, 2.0, (B, D)), dtype=torch.float32)
    rep = lr.init(diag, K)
    for _ in range(2):
        a = torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32)
        b = torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32)
        rep = lr.append_pair(rep, a, torch.full((B,), 0.5), b, torch.full((B,), -0.3))
    return rep


def _jax_cases():
    """(mesh string, JAX state, v) of tests/test_sharded_cov.py's two tests."""
    rng = np.random.default_rng(0)
    d, k = 64, 8
    rep = jlr.init(jnp.asarray(rng.uniform(0.5, 2, d), jnp.float32), k)
    rep = jlr.append_pair(rep, jnp.asarray(rng.normal(size=d), jnp.float32), 0.5,
                          jnp.asarray(rng.normal(size=d), jnp.float32), -0.3)
    first = ("model:4", rep, np.asarray(rng.normal(size=d), np.float32))
    rng = np.random.default_rng(1)
    d, k = 32, 4
    rep = jlr.init(jnp.asarray(rng.uniform(0.5, 2, d), jnp.float32), k)
    return [first, ("data:2,model:4", rep, np.asarray(rng.normal(size=d), np.float32))]


def _to_torch(rep):
    t = lambda a: torch.as_tensor(np.array(a, np.float32))[None]  # noqa: E731
    return (t(rep.diag), t(rep.Ut), t(rep.M), torch.tensor([int(rep.k)], dtype=torch.int64))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(0)
    cov = _state(rng)
    vec = lambda: torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32)  # noqa: E731
    x = vec()
    inputs = dict(cov=tuple(cov), v=vec(), a=vec(), b=vec(), x=x, x2=x + 0.1 * vec(),
                  m=vec(), m2=vec(), wa=torch.tensor([0.7, 0.2]), wb=torch.tensor([-0.1, 0.4]),
                  jax_cases=[(_to_torch(rep), torch.as_tensor(v)[None])
                             for _, rep, v in _jax_cases()])
    outs = run_world("cov", WORLD, f"data:1,model:{WORLD}", inputs,
                     tmp_path_factory.mktemp("cov"))
    return inputs, outs


def _close(got, want, what):
    want = want.double()
    scale = float(want.abs().max()) or 1.0
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5,
                               atol=2e-6 * scale, err_msg=what)


def _state_close(got, want, what):
    assert torch.equal(got["k"], want.k), what
    _close(got["diag"], want.diag, f"{what} diag")
    # compare the represented matrices through a probe: the columns of Ut
    # are determined up to the state's own algebra
    probe = torch.as_tensor(np.random.default_rng(5).normal(size=(B, D)), dtype=torch.float32)
    g = lr.matvec(lr.LowRank(got["diag"], got["Ut"], got["M"], got["k"]), probe)
    _close(g, lr.matvec(want, probe), f"{what} matvec")


def test_each_rank_holds_its_block_of_d(world4):
    _, outs = world4
    for r, o in enumerate(outs):
        assert o["diag_cols"] == D // WORLD
        assert o["block"].tolist() == [r * D // WORLD, (r + 1) * D // WORLD]
        assert o["group"] == (0, 1, r, WORLD)


@pytest.mark.parametrize("case", [0, 1])
def test_sharded_matvec_equals_jax_sharded_matvec(world4, case):
    _, outs = world4
    mesh_shape, rep, v = _jax_cases()[case]
    mesh = make_mesh(mesh_shape)
    sh = jshard_state(rep, mesh)
    want = np.asarray(jax.jit(jsharded_matvec(mesh))(
        sh.diag, sh.Ut, sh.M, jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("model")))))
    for o in outs:
        np.testing.assert_allclose(o["jax_cases"][case][0].numpy(), want, rtol=1e-5, atol=1e-6)


def test_sharded_matvec_equals_the_unsharded_port(world4):
    inputs, outs = world4
    want = lr.matvec(lr.LowRank(*inputs["cov"]), inputs["v"])
    for o in outs:
        _close(o["matvec"], want, "matvec")


def test_every_rank_gets_the_same_bits(world4):
    _, outs = world4
    for o in outs[1:]:
        assert torch.equal(o["matvec"], outs[0]["matvec"])
        assert torch.equal(o["space_update"]["Ut"], outs[0]["space_update"]["Ut"])


@pytest.mark.parametrize("name", ["inverse", "compress", "append", "time_update",
                                  "space_update"])
def test_reduce_taking_functions_equal_the_unsharded_port(world4, name):
    inputs, outs = world4
    cov = lr.LowRank(*inputs["cov"])
    want = {"inverse": lambda: lr.inverse(cov),
            "compress": lambda: lr.compress(cov, 3),
            "append": lambda: lr.append_pair(cov, inputs["a"], inputs["wa"], inputs["b"],
                                             inputs["wb"]),
            "time_update": lambda: cv.time_update(cov, 6.0, 2.5),
            "space_update": lambda: cv.space_update(cov, 2.5, inputs["x"], inputs["x2"],
                                                    inputs["m"], inputs["m2"])}[name]()
    for o in outs:
        _state_close(o[name], want, name)


@pytest.mark.parametrize("name", ["transport", "transport2"])
def test_transports_equal_the_unsharded_port(world4, name):
    inputs, outs = world4
    cov = lr.LowRank(*inputs["cov"])
    fn = cv.transport_score if name == "transport" else cv.transport_score_two_inverse
    mean, score = fn(cov, None, 6.0, 2.5, inputs["x"], inputs["v"])
    for o in outs:
        _close(o[name][0], mean, f"{name} mean")
        _close(o[name][1], score, f"{name} score")
