"""The port's multi-process runtime (``free_hunch_tpu_torch/parallel/``,
``utils/stats.py``, ``metrics/fid.py::allgather_merge`` and the driver's
``_process_mean`` / ``_process_sum``) in a real two-process gloo world on
the CPU, and its pure pieces against the JAX package's.

The ranks are ``tests/_torch_mp_worker.py`` subprocesses (the port only,
one thread each) that meet through a ``file://`` store in the test's
temporary directory, so parallel test workers cannot collide on a port;
every wait is bounded (``communicate(timeout=...)``, ``init(timeout=...)``).
The numbers are those ``tests/test_multiprocess.py`` asserts of the JAX
package: shards disjoint and covering [0, 10), sample-weighted means psnr
2.0, ssim (3 * 0.5 + 0.9) / 4, lpips (3 * 0.2 + 0.6) / 4, FID moments
merged bit-exactly, and ``stats`` with rank-divergent names."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from free_hunch_tpu.metrics import fid as jfid
from free_hunch_tpu.parallel import mesh as jmesh
from free_hunch_tpu.utils import stats as jstats
from free_hunch_tpu_torch.metrics import fid as tfid
from free_hunch_tpu_torch.parallel import dist, mesh
from free_hunch_tpu_torch.utils import stats as tstats
from tests._torch_parity import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mp_worker.py")
WAIT_S = 240


def spawn(mode, rank, world, store, outdir, payload=None, env=None):
    """One worker rank, its output piped; ``env`` adds to the environment."""
    args = [sys.executable, WORKER, mode, str(rank), str(world), str(store), str(outdir)]
    return subprocess.Popen(args + ([payload] if payload is not None else []), cwd=ROOT,
                            env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(procs, timeout=WAIT_S):
    """Each rank's output, every rank asserted to have exited 0."""
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both ranks' results of one ``collectives`` run."""
    d = tmp_path_factory.mktemp("world2")
    finish([spawn("collectives", r, 2, d / "store", d) for r in range(2)])
    return d, [json.loads((d / f"result_{r}.json").read_text()) for r in range(2)]


def test_ranks_and_world(world2):
    _, res = world2
    assert [r["rank"] for r in res] == [0, 1] and [r["world"] for r in res] == [2, 2]


def test_shards_are_disjoint_and_cover(world2):
    _, res = world2
    i0, i1 = set(res[0]["indices"]), set(res[1]["indices"])
    assert i0.isdisjoint(i1) and i0 | i1 == set(range(10))


def test_process_mean_weighs_by_samples(world2):
    for r in world2[1]:
        assert r["reduced"]["psnr"] == pytest.approx(2.0)
        assert r["reduced"]["ssim"] == pytest.approx((3 * 0.5 + 0.9) / 4)
        assert r["reduced"]["lpips"] == pytest.approx((3 * 0.2 + 0.6) / 4)


def test_process_sum_and_all_reduce_mean(world2):
    for r in world2[1]:
        assert r["summed"] == 4
        assert r["all_reduce_mean"] == pytest.approx((0 + 1 + 0 + 1 + 2) / 5, rel=1e-15)


def test_fid_moments_merge_bit_exactly_and_as_jax(world2):
    """Every rank holds the merged moments of one process that saw every
    feature, and the JAX FeatureStats merged from the same per-rank arrays
    in rank order, bit for bit."""
    d, res = world2
    assert [r["fid_merge_exact"] for r in res] == [True, True]
    rng = np.random.default_rng(0)
    feats = [rng.normal(1e3, 1.0, (3, 16)) for _ in range(2)]
    want = jfid.FeatureStats(16)
    for f in feats:
        one = jfid.FeatureStats(16)
        one.add(f)
        want.merge_arrays(one.n, one.s, one.ss)
    for r in range(2):
        with np.load(d / f"fid_{r}.npz") as got:
            assert int(got["n"]) == want.n == 6
            assert np.array_equal(got["s"], want.s) and np.array_equal(got["ss"], want.ss)


def test_stats_sync_lines_up_rank_divergent_names(world2):
    for r in world2[1]:
        for window in ("stats_first", "stats_second"):
            ss = r[window]
            assert ss["shared_num"] == 4 and ss["shared_mean"] == pytest.approx(1.5)
            assert ss["head_num"] == 1 and ss["head_mean"] == pytest.approx(7.0)


def test_checkpointio_rank0_writes_every_rank_reads(world2):
    for r in world2[1]:
        ck = r["ckpt"]
        assert ck["first"] == [10, 1]  # rank 0's box of step 1
        assert ck["latest"] == "state-0002.pkl" and ck["latest_box"] == 20
        assert ck["none"] is None


def test_allgather_merge_in_a_world_of_one_is_the_identity():
    st = tfid.FeatureStats(8)
    st.add(np.random.default_rng(1).normal(size=(5, 8)))
    got = tfid.allgather_merge(st)
    assert got.n == 5 and np.array_equal(got.s, st.s) and np.array_equal(got.ss, st.ss)


@pytest.fixture
def fresh_stats(monkeypatch):
    monkeypatch.setattr(tstats, "_counters", {})
    monkeypatch.setattr(jstats, "_counters", {})
    monkeypatch.setattr(tstats, "_rank0_only", False)
    monkeypatch.setattr(jstats, "_rank0_only", False)


def test_collector_in_a_world_of_one_equals_jax(fresh_stats):
    rng = np.random.default_rng(3)
    reports = [("loss", rng.normal(size=5)), ("loss", rng.normal(size=3)), ("acc", 0.25),
               ("empty", np.zeros(0)), ("acc", [0.5, 0.75])]
    for mod in (tstats, jstats):
        for name, value in reports:
            mod.report(name, value)
        mod.report0("head", 7.0)
    tc, jc = tstats.Collector(), jstats.Collector()
    for c in (tc, jc):
        c.update()
    assert tc.names() == jc.names() == ["loss", "acc", "head"]
    assert tc.as_dict() == jc.as_dict()
    for name in ("loss", "acc", "head", "absent"):
        assert np.array_equal(tc._get(name), jc._get(name))
    tstats.report("loss", 1.0)
    jstats.report("loss", 1.0)
    tc2, jc2 = tstats.Collector("lo.*", keep_previous=False), \
        jstats.Collector("lo.*", keep_previous=False)
    assert tc2.as_dict() == jc2.as_dict() and tc2.num("loss") == 1
    tstats.init_multiprocessing(rank=1)
    tstats.report0("head", 1.0)
    assert tstats._counters["head"][0] == 0


def test_should_stop_and_should_suspend(tmp_path, monkeypatch):
    stop, suspend = tmp_path / "stop", tmp_path / "suspend"
    monkeypatch.delenv("FREE_HUNCH_STOP_FILE", raising=False)
    monkeypatch.delenv("FREE_HUNCH_SUSPEND_FILE", raising=False)
    assert not dist.should_stop() and not dist.should_suspend()
    monkeypatch.setenv("FREE_HUNCH_STOP_FILE", str(stop))
    monkeypatch.setenv("FREE_HUNCH_SUSPEND_FILE", str(suspend))
    assert not dist.should_stop() and not dist.should_suspend()
    stop.write_text("")
    assert dist.should_stop() and not dist.should_suspend()
    suspend.write_text("")
    assert dist.should_suspend()


@pytest.mark.parametrize("cards", [1, 2, 8])
def test_local_device_gives_each_rank_its_own_card(cards):
    devs = [dist.local_device(r, cards) for r in range(8)]
    assert devs == [torch.device(f"cuda:{r % cards}") for r in range(8)]
    assert len(set(devs[:cards])) == cards  # no two ranks of one host share while cards last
    with pytest.raises(ValueError, match="no CUDA card"):
        dist.local_device(0, 0)


def test_init_in_a_world_of_one_joins_nothing(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    dist.init()
    dist.init(world_size=1, rank=0)
    assert not tdist.is_initialized()
    assert (dist.get_rank(), dist.get_world_size(), dist.get_local_rank()) == (0, 1, 0)
    assert dist.all_gather(np.arange(3)).tolist() == [[0, 1, 2]]
    assert dist.all_gather_object({"a": 1}) == [{"a": 1}]


def test_init_needs_the_rank(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="rank"):
        dist.init(world_size=2)
    assert not tdist.is_initialized()


@pytest.mark.parametrize("local_world,cards,want", [
    (1, 0, "gloo"), (2, 0, "gloo"), (2, 1, "gloo"), (8, 4, "gloo"),
    (1, 1, "nccl"), (2, 2, "nccl"), (4, 8, "nccl"), (8, 8, "nccl")])
def test_default_backend_is_nccl_only_with_a_card_per_rank(local_world, cards, want):
    assert dist.default_backend(local_world, cards) == want


def test_rank_device_is_the_card_or_raises(monkeypatch):
    assert dist.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.rank_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist.rank_device(None) == torch.device("cuda:0")


MESH_STRINGS = ["data:-1", "data:1", "data:4", "data:4,model:2", "data:-1,model:2",
                "model:2,data:-1", "data", "data:2,model:-1", " data:1 , model:1 "]


@pytest.mark.parametrize("n_devices", [1, 4, 8])
@pytest.mark.parametrize("spec", MESH_STRINGS)
def test_parse_mesh_shape_equals_jax(spec, n_devices):
    assert mesh.parse_mesh_shape(spec, n_devices) == jmesh.parse_mesh_shape(spec, n_devices)


def test_parse_mesh_shape_defaults_to_the_one_card_of_a_process():
    assert mesh.parse_mesh_shape("data:-1") == {"data": 1}


@pytest.mark.parametrize("spec,exc,match", [("data:4,model:2", ValueError, "item 15"),
                                            ("data:1,model:2", ValueError, "model axis"),
                                            ("data:2", ValueError, "nproc_per_node=2")])
def test_check_mesh_shape_refuses_what_one_process_cannot_drive(spec, exc, match):
    with pytest.raises(exc, match=match):
        mesh.check_mesh_shape(spec)


@pytest.mark.parametrize("spec", [None, "data:-1", "data:1", "data:1,model:1"])
def test_check_mesh_shape_takes_one_card(spec):
    assert mesh.check_mesh_shape(spec)["data"] == 1


def test_all_reduce_mean_of_one_process_is_the_mean():
    v = np.random.default_rng(2).normal(size=(3, 4))
    assert mesh.all_reduce_mean(v) == pytest.approx(float(np.mean(v)), rel=1e-15)
