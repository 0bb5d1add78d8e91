"""The port's tracer (``utils/profiling.py``) inside the guided call, on the
CPU: a tiny 32 px Free Hunch run (vjp gradient, gaussian blur, recycled CG
starts) under ``profiling.trace``.

* the spans nest: each ``mech.call`` holds the four ``fh.*`` stages, and
  every ``host.read`` lies in ``fh.solve`` (the CG's stopping tests) or in
  ``fh.cov_update`` (``x_changed``, the compress check);
* ``host_reads`` is the CG's ``host_syncs`` plus the reads in the
  covariance update; the CG tallies hold one entry per row and solve;
* the stages' walls (host clock on a CPU) add up to the calls' time;
* planted CG cases read their stopping reason;
* with no profiler recording, no range is entered and nothing is counted.

A pytest worker runs many files in one process, so each run resets the
tracer first."""
import time

import pytest
import torch

from free_hunch_tpu_torch.guidance import mechanisms as mech
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond
from free_hunch_tpu_torch.models.unet import UNetConfig, UNetModel
from free_hunch_tpu_torch.operators import get_operator
from free_hunch_tpu_torch.ops import cg as cg_mod
from free_hunch_tpu_torch.samplers import edm
from free_hunch_tpu_torch.utils import misc, profiling
from tests._torch_parity import one_thread  # noqa: F401

RES, B, STEPS = 32, 2, 5
STAGES = ("fh.denoise", "fh.cov_update", "fh.solve", "fh.guide")


def _precond():
    torch.manual_seed(0)
    cfg = UNetConfig(image_size=RES, model_channels=32, num_res_blocks=1,
                     attention_resolutions=(4,), channel_mult=(1, 2), num_heads=2,
                     num_head_channels=16, dtype=torch.float32, remat=False)
    model = UNetModel(cfg).eval().requires_grad_(False)
    with torch.no_grad():   # the zero-initialised output conv would make D trivial
        for p in model.parameters():
            if not p.abs().max():
                p.normal_(0.0, 0.02)
    return IDDPMLinearPrecond(model, img_resolution=RES, img_channels=3)


def _setup():
    pre = _precond()
    xs, s0 = edm.prepare_schedule(round_sigma=pre.round_sigma, net_sigma_min=pre.sigma_min,
                                  net_sigma_max=pre.sigma_max, num_steps=STEPS, solver="heun",
                                  discretization="edm", schedule="linear", scaling="none")
    op = get_operator("gaussian_blur", in_shape=(1, 3, RES, RES), sigma_s=0.1, device="cpu")
    fh = mech.FreeHunch(cond_scaling=1.0, forward_operator=op,
                        image_base_covariance="dct_diagonal_noinfo", data_dim=3 * RES * RES,
                        cov_capacity=edm.required_cov_capacity(xs), cg_warm_start="prev",
                        guidance_gradient="vjp")
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((B, 3, RES, RES), generator=g)
    y = op.forward(torch.rand((B, 3, RES, RES), generator=g) * 2 - 1, noiseless=True)
    return pre, fh, xs, s0, noise, y


class _Timed:
    """The mechanism, each call timed on the host and its CG reads summed."""

    def __init__(self, m):
        self.m, self.call_s, self.cg_syncs = m, [], 0

    def init_state(self, batch, shape):
        return self.m.init_state(batch, shape)

    def __call__(self, denoise, x_t, y, sigma, state):
        t = time.perf_counter()
        out = self.m(denoise, x_t, y, sigma, state)
        self.call_s.append(time.perf_counter() - t)
        self.cg_syncs += out[1].cg_host_syncs
        return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    pre, fh, xs, s0, noise, y = _setup()
    timed = _Timed(fh)
    profiling.reset()
    with profiling.trace(str(tmp_path_factory.mktemp("tr")), device="cpu") as prof:
        edm.sample_loop(pre, timed, noise, y, xs, sigma0_scaled=s0)
    snap = profiling.snapshot()
    ev = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
          if e.name in STAGES + ("mech.call", "host.read")]
    return snap, ev, timed


def _inside(e, outer):
    return any(o[3] == e[3] and o[1] <= e[1] and e[2] <= o[2] for o in outer)


def test_the_spans_nest_inside_each_guided_call(traced):
    snap, ev, timed = traced
    calls = [e for e in ev if e[0] == "mech.call"]
    assert len(calls) == 2 * STEPS - 1 == len(timed.call_s) == snap["calls"]["mech.call"]
    for c in calls:
        inner = {e[0] for e in ev if e[0] in STAGES and _inside(e, [c])}
        assert inner == set(STAGES)
    for name in STAGES:
        assert snap["calls"][name] == len(calls)
        assert all(_inside(e, calls) for e in ev if e[0] == name)
    reads = [e for e in ev if e[0] == "host.read"]
    solve = [e for e in ev if e[0] == "fh.solve"]
    upd = [e for e in ev if e[0] == "fh.cov_update"]
    assert reads and all(_inside(e, solve) or _inside(e, upd) for e in reads)
    assert len(reads) == snap["counts"]["host_reads"] == snap["calls"]["host.read"]
    # the covariance update read the card: x_changed and the compress check
    in_upd = sum(_inside(e, upd) for e in reads)
    assert in_upd > 0
    assert snap["counts"]["host_reads"] == timed.cg_syncs + in_upd


def test_the_cg_tallies_hold_every_row_of_every_solve(traced):
    snap = traced[0]
    solves = snap["counts"]["cg.solves"]
    assert solves == snap["calls"]["mech.call"]
    rows, no_step = snap["tallies"]["cg.rows"], snap["tallies"]["cg.no_step"]
    assert tuple(rows) == cg_mod.STOP_REASONS
    assert sum(rows.values()) == sum(no_step.values()) == B * solves


def test_the_stage_walls_add_up_to_the_calls(traced):
    snap, _, timed = traced
    walls = sum(snap["device_s"][name] for name in STAGES)
    assert set(snap["device_s"]) == set(STAGES)
    assert abs(walls - sum(timed.call_s)) <= 0.1 * sum(timed.call_s)


def _solve(matvec, b, tmp_path, **kw):
    profiling.reset()
    with profiling.trace(str(tmp_path), device="cpu"):
        x, info = cg_mod.cg_batch(matvec, b, **kw)
    return x, info, profiling.snapshot()


@pytest.mark.parametrize("case", ["maxiter", "breakdown", "tol"])
def test_planted_cg_rows_read_their_stopping_reason(case, tmp_path):
    g = torch.Generator().manual_seed(5)
    b = torch.randn((3, 64), generator=g)
    spread = torch.linspace(1.0, 1e3, 64)
    mv = {"maxiter": lambda v: v * spread, "breakdown": lambda v: -v,
          "tol": lambda v: 2.0 * v}[case]
    kw = dict(maxiter=1) if case == "maxiter" else {}
    x, info, snap = _solve(mv, b, tmp_path, rtol=1e-6, **kw)
    rows = snap["tallies"]["cg.rows"]
    assert rows[case] == 3 and sum(rows.values()) == 3
    no_step = snap["tallies"]["cg.no_step"]
    assert no_step["no_step"] == (3 if case == "breakdown" else 0)
    if case == "breakdown":
        assert torch.equal(x, torch.zeros_like(b))
    assert snap["counts"]["host_reads"] == info.host_syncs


def test_a_row_met_at_its_start_reads_tol_and_counts_as_other(tmp_path):
    b = torch.ones((2, 8))
    _, info, snap = _solve(lambda v: v, b, tmp_path, x0=b.clone())
    assert info.niter == 0
    assert snap["tallies"]["cg.rows"]["tol"] == 2 and snap["tallies"]["cg.no_step"]["no_step"] == 0


def test_off_no_range_is_entered_and_nothing_is_counted(monkeypatch):
    """A vjp guided call with no profiler recording: ``record_function`` is
    never entered and the tracer's snapshot does not change."""
    pre, fh, xs, s0, noise, y = _setup()
    st = fh.init_state(B, noise.shape[1:])
    x0, st = fh(pre, noise * 80.0, y, 80.0, st)
    before = profiling.snapshot()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for sigma in (5.0, 5.0):
        x0, st = fh(pre, x0 + sigma * noise, y, sigma, st)
    with misc.profiled_region("off"), profiling.annotate("off"):
        misc.profiled_function(lambda: None)()
    assert st.step == 3 and st.cg_host_syncs > 0
    assert profiling.snapshot() == before


def test_on_a_span_enters_the_profiler_range_and_counts(tmp_path):
    profiling.reset()
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.span("outer", device="cpu", args={"step": 1}):
            profiling.count("things", 2)
            assert profiling.host_read(torch.tensor(True))
            profiling.tally("bins", torch.tensor([0, 1, 1]), ("a", "b"))
    snap = profiling.snapshot()
    assert {e.key for e in prof.key_averages()} >= {"outer", "host.read"}
    assert snap["calls"] == {"outer": 1, "host.read": 1}
    assert snap["counts"] == {"things": 2, "host_reads": 1}
    assert snap["tallies"] == {"bins": {"a": 1, "b": 2}}
    assert set(snap["device_s"]) == {"outer"} and snap["device_s"]["outer"] > 0
    profiling.reset()
    assert profiling.snapshot() == {"calls": {}, "counts": {}, "device_s": {}, "tallies": {}}
