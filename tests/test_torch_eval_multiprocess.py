"""The port's evaluation driver (``free_hunch_tpu_torch/eval.py``) in a world
of two gloo ranks on the CPU, at the 32 px setup of
``tests/test_torch_eval.py`` (DPS on inpainting with a fresh mask per
image, 3 Heun steps, batch 2; and DDNM+, whose driver inherits the
world-of-N code) on the bundled images.

* Each rank's journal equals, record by record, a world-of-one run of the
  port over that rank's shard with that rank's generators: the test
  impersonates the rank by patching ``get_rank`` / ``get_world_size`` in
  the port's ``eval`` module. ``tests/test_torch_eval.py`` holds the
  world-of-one driver to the JAX package's, which closes the chain.
* Kill and resume, after ``tests/test_multiprocess.py::
  test_two_process_kill9_resume``: rank 1, armed by both gates
  (``fault_kill_after_batches=1`` and ``FREE_HUNCH_FAULT_INJECT=1``),
  SIGKILLs itself after its first batch; the survivor is killed after a
  bounded wait; both restart with ``resume=true``. Every journal is then
  byte for byte the uninterrupted run's, and so are the totals.
* The hook never fires with only one of its gates set.
"""
import json
import os
import signal
import subprocess
import uuid

import pytest

from free_hunch_tpu_torch import config as tcfg
from free_hunch_tpu_torch import eval as teval
from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator
from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_dist import finish, spawn
from tests.test_torch_eval import SETUP32, _args


@pytest.fixture(scope="module")
def setup32(tmp_path_factory):
    p = tmp_path_factory.mktemp("models") / "setup32.txt"
    p.write_text(SETUP32)
    return str(p)


def _world(tmp_path, setup32, name, envs=({}, {}), **over):
    """Start both ranks of a driver run in ``tmp_path/name``."""
    opts = json.dumps(_args(tmp_path, setup32, name, num_steps=3, **over))
    store = tmp_path / f"store_{uuid.uuid4().hex}"
    return [spawn("eval", r, 2, store, tmp_path / name, opts, env=envs[r]) for r in range(2)]


def _journal_bytes(outdir, rank):
    return (outdir / f"metrics_rank{rank:02d}.jsonl").read_bytes()


def _records(outdir, rank):
    return [json.loads(line) for line in _journal_bytes(outdir, rank).decode().splitlines()]


def _one_rank(tmp_path, setup32, monkeypatch, rank, name, **over):
    """The port alone, as rank ``rank`` of two, in a world of one."""
    monkeypatch.setattr(teval, "get_rank", lambda: rank)
    monkeypatch.setattr(teval, "get_world_size", lambda: 2)
    args = _args(tmp_path, setup32, name, num_steps=3, **over)
    cls = DDNMEvaluator if args["conditioning_mechanism"] == "ddnm" else teval.Evaluator
    return cls(tcfg.load_config(args=args), device="cpu").run()


@pytest.mark.parametrize("mech", ["dps", "ddnm"])
def test_a_world_of_two_equals_its_ranks_run_alone(tmp_path, setup32, monkeypatch, mech):
    finish(_world(tmp_path, setup32, "world", conditioning_mechanism=mech))
    out = tmp_path / "world"
    results = json.loads((out / "results.json").read_text())
    for rank in range(2):
        _one_rank(tmp_path, setup32, monkeypatch, rank, f"alone{rank}",
                  conditioning_mechanism=mech)
        alone = tmp_path / f"alone{rank}"
        assert _records(out, rank) == _records(alone, rank)
        assert (alone / "results.json").exists() == (rank == 0)
        worker = json.loads((out / f"worker_result_{rank}.json").read_text())
        assert {k: worker[k] for k in results if k != "time_taken"} == \
            {k: results[k] for k in results if k != "time_taken"}
    recs = _records(out, 0) + _records(out, 1)
    assert [r["n"] for r in recs] == [2, 1]
    n = sum(r["n"] for r in recs)
    for k in ("psnr", "ssim", "lpips"):
        assert results[k] == pytest.approx(sum(r[k] * r["n"] for r in recs) / n, rel=1e-12)
    assert results["images"] == 3 and results["resumed_batches"] == 0
    assert sorted(os.listdir(out / "images")) == [f"00000{i}_000000.png" for i in range(3)]


def test_kill_and_resume_reproduces_the_uninterrupted_run(tmp_path, setup32):
    over = dict(total_images=6)  # per rank three images: batches of 2 and 1
    finish(_world(tmp_path, setup32, "whole", **over))
    whole = tmp_path / "whole"
    want = [_journal_bytes(whole, r) for r in range(2)]
    results_whole = json.loads((whole / "results.json").read_text())

    armed = {"FREE_HUNCH_FAULT_INJECT": "1"}
    procs = _world(tmp_path, setup32, "fault", envs=({}, armed),
                   fault_kill_after_batches=1, **over)
    out1 = procs[1].communicate(timeout=240)[0]
    assert procs[1].returncode == -signal.SIGKILL, out1[-2000:]
    try:  # the survivor waits for its dead peer in the final gather
        procs[0].communicate(timeout=60)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].communicate()
    fault = tmp_path / "fault"
    assert len(_records(fault, 1)) == 1
    assert _journal_bytes(fault, 1) == want[1].splitlines(keepends=True)[0]
    assert not (fault / "results.json").exists()
    journaled = sum(len(_records(fault, r)) for r in range(2))

    outs = finish(_world(tmp_path, setup32, "fault", resume=True, **over))
    assert [_journal_bytes(fault, r) for r in range(2)] == want
    results = json.loads((fault / "results.json").read_text())
    assert results["resumed_batches"] == journaled == 3
    assert outs[1].count("resumed from journal") == 1  # rank 1's armed count
    for k in ("psnr", "ssim", "lpips", "images"):
        assert results[k] == results_whole[k]


@pytest.mark.parametrize("opt,env", [(1, None), (None, "1"), (1, "0")])
def test_the_fault_hook_needs_both_gates(tmp_path, setup32, monkeypatch, opt, env):
    kills = []
    monkeypatch.setattr(os, "kill", lambda *a: kills.append(a))
    if env is None:
        monkeypatch.delenv("FREE_HUNCH_FAULT_INJECT", raising=False)
    else:
        monkeypatch.setenv("FREE_HUNCH_FAULT_INJECT", env)
    over = {} if opt is None else dict(fault_kill_after_batches=opt)
    res = teval.Evaluator(tcfg.load_config(args=_args(tmp_path, setup32, "gate", num_steps=2,
                                                      total_images=2, **over)),
                          device="cpu").run()
    assert kills == [] and res["images"] == 2


def test_the_fault_hook_fires_with_both_gates(tmp_path, setup32, monkeypatch):
    """In process, with ``os.kill`` caught: the kill comes after the
    configured count of computed batches, once their journal records are
    on disk, and aims SIGKILL at this process."""
    class Killed(Exception):
        pass

    def kill(pid, sig):
        raise Killed(pid, sig)

    monkeypatch.setattr(os, "kill", kill)
    monkeypatch.setenv("FREE_HUNCH_FAULT_INJECT", "1")
    args = _args(tmp_path, setup32, "fires", num_steps=2, total_images=3, batch_size=1,
                 fault_kill_after_batches=2)
    with pytest.raises(Killed) as e:
        teval.Evaluator(tcfg.load_config(args=args), device="cpu").run()
    assert e.value.args == (os.getpid(), signal.SIGKILL)
    assert [r["batch"] for r in _records(tmp_path / "fires", 0)] == \
        ["000000_000000", "000001_000000"]
