"""The port's evaluation driver with a model axis (``mesh_shape=data:N,
model:M``) in CPU gloo worlds, Free Hunch on the 32 px setup of
``tests/test_torch_eval.py`` (gaussian blur, the flat DCT prior, 3 Heun
steps, batch 1, four bundled images): ``data:1,model:2`` (two ranks) and
``data:2,model:2`` (four ranks, two model groups).

* Each data group's journal holds one record per image, within 1e-2 of the
  data-parallel run without a model axis that draws alike (a world of one
  for ``data:1``; for ``data:2`` each group against that rank of a world of
  two, run alone as ``tests/test_torch_eval_multiprocess.py`` does): the
  metrics of an 8-bit code that flips at a rounding tie move by that much.
* ``results.json`` counts each image once, and its totals are the
  sample-weighted mean of the journals; one journal per data group.
* A resumed run replays every group's journal on all of its ranks.
* DDNM+ with a model axis raises on every rank, naming ROADMAP item 15b.
"""
import json
import uuid

import pytest

from free_hunch_tpu_torch import config as tcfg
from free_hunch_tpu_torch import eval as teval
from tests._torch_parity import one_thread  # noqa: F401
from tests._torch_sharded import wait_all
from tests.test_torch_dist import spawn
from tests.test_torch_eval import SETUP32, _args

TOTAL = 4
FH = dict(conditioning_mechanism="online_covariance", operator_name="gaussian_blur",
          image_base_covariance="dct_diagonal_noinfo", cov_capacity=8, num_steps=3,
          total_images=TOTAL, batch_size=1, noise_sigma=0.1)
METRICS = ("psnr", "ssim", "lpips")


@pytest.fixture(scope="module")
def setup32(tmp_path_factory):
    p = tmp_path_factory.mktemp("models") / "setup32.txt"
    p.write_text(SETUP32)
    return str(p)


def _world(tmp, setup32, name, mesh_shape, world, ok=True, **over):
    opts = json.dumps(_args(tmp, setup32, name, mesh_shape=mesh_shape, **dict(FH, **over)))
    store = tmp / f"store_{uuid.uuid4().hex}"
    procs = [spawn("eval", r, world, store, tmp / name, opts) for r in range(world)]
    return wait_all(procs, f"driver {mesh_shape}", ok=ok)


def _records(outdir, group):
    path = outdir / f"metrics_rank{group:02d}.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _alone(tmp, setup32, monkeypatch, rank, world, name):
    """The driver without a model axis, as rank ``rank`` of ``world``."""
    monkeypatch.setattr(teval, "get_rank", lambda: rank)
    monkeypatch.setattr(teval, "get_world_size", lambda: world)
    args = _args(tmp, setup32, name, **FH)
    teval.Evaluator(tcfg.load_config(args=args), device="cpu").run()
    return _records(tmp / name, rank)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, setup32):
    tmp = tmp_path_factory.mktemp("sharded_eval")
    for name, mesh_shape, world in (("m2", "data:1,model:2", 2), ("d2m2", "data:2,model:2", 4)):
        _world(tmp, setup32, name, mesh_shape, world)
    return tmp


@pytest.mark.parametrize("name,groups", [("m2", 1), ("d2m2", 2)])
def test_each_image_counts_once(runs, name, groups):
    out = runs / name
    results = json.loads((out / "results.json").read_text())
    assert results["images"] == TOTAL and results["resumed_batches"] == 0
    assert sorted(p.name for p in out.glob("metrics_rank*.jsonl")) == \
        [f"metrics_rank{g:02d}.jsonl" for g in range(groups)]
    recs = [r for g in range(groups) for r in _records(out, g)]
    assert sorted(r["batch"] for r in recs) == [f"{i:06d}_000000" for i in range(TOTAL)]
    assert len(list((out / "images").glob("*.png"))) == TOTAL
    for k in METRICS:
        assert results[k] == pytest.approx(sum(r[k] for r in recs) / TOTAL, rel=1e-12)


@pytest.mark.parametrize("name,world", [("m2", 1), ("d2m2", 2)])
def test_per_image_metrics_equal_the_run_without_a_model_axis(runs, setup32, monkeypatch,
                                                              tmp_path, name, world):
    for group in range(world):
        want = _alone(tmp_path, setup32, monkeypatch, group, world, f"alone{group}")
        got = _records(runs / name, group)
        assert [r["batch"] for r in got] == [r["batch"] for r in want]
        for g, w in zip(got, want):
            for k in METRICS:
                assert abs(g[k] - w[k]) <= 1e-2, (name, g["batch"], k, g[k], w[k])


def test_resume_replays_every_group_journal(runs, setup32):
    before = json.loads((runs / "d2m2" / "results.json").read_text())
    journals = [(runs / "d2m2" / f"metrics_rank{g:02d}.jsonl").read_bytes() for g in range(2)]
    _world(runs, setup32, "d2m2", "data:2,model:2", 4, resume=True)
    after = json.loads((runs / "d2m2" / "results.json").read_text())
    assert after["resumed_batches"] == TOTAL and after["images"] == TOTAL
    assert [(runs / "d2m2" / f"metrics_rank{g:02d}.jsonl").read_bytes()
            for g in range(2)] == journals
    for k in METRICS:
        assert after[k] == before[k]


def test_ddnm_with_a_model_axis_raises_on_every_rank(tmp_path, setup32):
    outs = _world(tmp_path, setup32, "ddnm", "data:1,model:2", 2, ok=False,
                  conditioning_mechanism="ddnm", operator_name="inpainting")
    for out in outs:
        assert "DDNM+ takes no model axis" in out and "item 15b" in out
