"""The readers of the program's own tracer on the tiny traced CPU run (as
``test_benchmark_spec.py::traced_run`` makes it): the counter metrics read
numbers, every read of the card is a host read, and the idle metrics, which
need the card's activity, read nothing. The tracer is process-wide and
pytest runs the benchmark's files in one process, so the run resets it
first."""
import time

import pytest

from _tiny import BENCH, tiny_cell

import spec  # noqa: E402

COUNTERS = ("cov_update_device_ms", "solve_device_ms", "guide_device_ms",
            "host_reads_per_call", "cg_rows_unmet_share")
IDLE = ("solve_idle_ms", "guide_idle_ms")


@pytest.fixture(scope="module")
def traced_line():
    import torch

    import harness
    import run
    from free_hunch_tpu_torch.utils import profiling
    torch.set_num_threads(2)
    profiling.reset()
    c = tiny_cell()
    res = harness.run_cell(c, 2 ** 31 + 4321, 2.0, True, time.time(), device="cpu",
                           cache_dir=BENCH.parent / ".bench_cache" / "data")
    return c, res, run.result_line(c, spec.benchmark(), res, True, "cpu", 1)


def test_the_counter_metrics_read_numbers(traced_line):
    c, res, line = traced_line
    m = {k: v["value"] for k, v in line["metrics"].items()}
    for name in COUNTERS:
        assert isinstance(m[name], float) and m[name] >= 0, name
    assert m["cov_update_device_ms"] > 0 and m["solve_device_ms"] > 0 and m["guide_device_ms"] > 0
    assert m["cg_rows_unmet_share"] <= 100


def _inside(h, spans):
    return any(s <= h[1] and h[2] <= e for _, s, e in spans)


def test_every_cg_read_is_a_host_read(traced_line):
    """``host_reads_per_call`` against the CG's reads of the same calls: the
    ``host.read`` ranges inside ``fh.solve`` in the stretch's trace (each is
    one of ``cg_host_syncs``). ``host_syncs_per_call`` averages the window's
    calls, another stretch of the schedule, so it is not the comparison."""
    c, res, line = traced_line
    m = {k: v["value"] for k, v in line["metrics"].items()}
    host = res["trace"].host
    n = c["traffic"]["trace"]["calls"]
    reads = [h for h in host if h[0] == "host.read"]
    solve = [h for h in host if h[0] == "fh.solve"]
    upd = [h for h in host if h[0] == "fh.cov_update"]
    in_solve = sum(_inside(h, solve) for h in reads)
    assert in_solve > 0 and m["host_syncs_per_call"] > 0
    assert m["host_reads_per_call"] * n == len(reads) == in_solve + sum(
        _inside(h, upd) for h in reads)
    assert m["host_reads_per_call"] >= in_solve / n


def test_the_stretch_is_what_the_tracer_counted(traced_line):
    import tracer
    c, res, _ = traced_line
    snap = tracer.snapshot()
    assert tracer.calls(snap) == c["traffic"]["trace"]["calls"]
    rows = sum(snap["tallies"]["cg.rows"].values())
    assert rows == c["traffic"]["batch"] * snap["counts"]["cg.solves"]


def test_the_idle_metrics_read_nothing_without_a_card(traced_line):
    c, res, line = traced_line
    for name in IDLE:
        assert name not in line["metrics"]
        assert spec.reader(name)(dict(res, cell=c)) is None


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    from free_hunch_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    for name in COUNTERS + IDLE:
        assert spec.reader(name)({"trace": None}) is None, name
