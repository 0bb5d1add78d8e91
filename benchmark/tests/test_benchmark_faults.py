"""The check refuses a broken program: the harness's whole run on the CPU
at a tiny size (no look for a card), with the timed path broken
underneath, reads ``correct`` false; sound, it reads true. And the
control, the stages one precision below the configured ones, reads not
correct."""
import time

import pytest
import torch

from _tiny import BENCH, tiny_cell

import compare  # noqa: E402
import harness  # noqa: E402

CELLS = ("imagenet256-blur-vjp", "imagenet256-inpaint-covgrad")


class OneRun(harness.Boundary):
    """The window closes at the second run's first call: it holds the first
    run whole, as ``run_seconds`` does on the card, however slow the CPU."""

    def __call__(self, denoise, x_t, y, sigma, state):
        if self.captures is not None and self.captures.run > 0:
            self.deadline = 0.0
        return super().__call__(denoise, x_t, y, sigma, state)


class CloseInRun0(harness.Boundary):
    """The window closes at run 0's sixth call, as a ``seconds`` shorter
    than one run does."""

    def __call__(self, denoise, x_t, y, sigma, state):
        if self.captures is not None and self.captures.run == 0 and self.in_run == 5 and \
                self.t_close is None:
            self.deadline = 0.0
        return super().__call__(denoise, x_t, y, sigma, state)


def run(cell, seed=2 ** 31 + 77):
    """The harness's run of ``cell`` on the CPU, the window one whole run:
    (correct, result), every number read."""
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "Boundary", OneRun)
        res = harness.run_cell(cell, seed, 600.0, False, time.time(), device="cpu",
                               cache_dir=BENCH.parent / ".bench_cache" / "data")
    assert res["runs_done"] == 1 and set(res["numbers"]) >= set(cell["limits"]), res
    return compare.verdict(res["numbers"], cell["limits"]) and res["failed"] == 0, res


def state_unchanged(mp):
    """Each guided call hands back the state it found."""
    from free_hunch_tpu_torch.guidance import mechanisms
    real = mechanisms.FreeHunch.x0_mean_update

    def call(self, denoise, x_t, y, sigma, state):
        x0, new = real(self, denoise, x_t, y, sigma, state)
        return x0, state._replace(cg_niter=new.cg_niter, cg_host_syncs=new.cg_host_syncs)
    mp.setattr(mechanisms.FreeHunch, "x0_mean_update", call)


def half_batch(mp):
    """The denoiser computes the first half of the batch; the rest keeps x."""
    from free_hunch_tpu_torch.models import precond
    real = precond._Precond.forward

    def fwd(self, x, sigma, y=None):
        h = x.shape[0] // 2
        d, v = real(self, x[:h], sigma, y)
        return torch.cat([d, torch.clamp(x[h:], -1, 1)]), torch.cat([v, v])
    mp.setattr(precond._Precond, "forward", fwd)


def answer_altered(mp):
    """One image's guided output is moved by 1e-2 where it is produced."""
    from free_hunch_tpu_torch.guidance import mechanisms
    real = mechanisms.FreeHunch.x0_mean_update

    def call(self, denoise, x_t, y, sigma, state):
        x0, new = real(self, denoise, x_t, y, sigma, state)
        x0 = x0.clone()
        x0[-1] += 1e-2
        return x0, new
    mp.setattr(mechanisms.FreeHunch, "x0_mean_update", call)


def step_unchanged(mp):
    """The sampler's Heun update returns the point it started from."""
    from free_hunch_tpu_torch.samplers import edm
    real = edm.sample_loop

    def loop(denoise, mechanism, noise, y, xs, generator=None, **kw):
        xs = dict(xs, h=xs["h"] * 0)
        return real(denoise, mechanism, noise, y, xs, generator, **kw)
    mp.setattr(edm, "sample_loop", loop)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    ok, res = run(tiny_cell(cell, torso="float32"))
    assert ok, res["numbers"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered, step_unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    ok, res = run(tiny_cell(cell, torso="float32"))
    assert not ok, res["numbers"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The control (control.py) at the tiny size on the CPU: the program's
    int8 torso, the algebra one step below float32 (TF32, which the CPU
    does not have: float32 there, or bfloat16), the Heun update and the
    start in bfloat16."""
    import control
    import inputs
    import weights as weights_mod
    from _tiny import ADM
    torch.set_num_threads(2)
    c = tiny_cell(cell, torso="float32")
    dev = torch.device("cpu")
    arch = ADM.arch_of(c["config"]["model"])
    w = weights_mod.make(ADM.param_shapes(arch), 3, dev, c["config"]["precision"])
    prog = harness.Program(c, w, dev)
    ctl = harness.Program(c, w, dev, quant="int8")
    images = inputs.bundled_images(BENCH.parent / ".bench_cache" / "data")
    r = control.seed_readings(c, 2 ** 31 + 5, prog, ctl, images, dev, True)
    assert compare.verdict(r["program"], c["limits"]), r
    assert not compare.verdict(r["control"], c["limits"]), r


@pytest.mark.parametrize("close", ["at_the_first_call", "at_the_sixth_call"])
def test_a_window_shorter_than_one_run_still_checks_every_step(close, monkeypatch):
    """The window closes inside run 0 (``seconds`` 0, or at its sixth call):
    it counts only the calls before it, and run 0 goes on untimed, so the
    check judges every sampled step, with the numbers of a window that
    holds run 0 whole."""
    c = tiny_cell("imagenet256-blur-vjp", torso="float32")
    _, whole = run(c, seed=2 ** 31 + 99)
    torch.set_num_threads(2)
    if close == "at_the_sixth_call":
        monkeypatch.setattr(harness, "Boundary", CloseInRun0)
    res = harness.run_cell(c, 2 ** 31 + 99, 0.0 if close == "at_the_first_call" else 600.0,
                           False, time.time(), device="cpu",
                           cache_dir=BENCH.parent / ".bench_cache" / "data")
    assert res["runs_done"] == 0 and res["runs_started"] == 1 and res["failed"] == 0
    assert res["calls"] == (0 if close == "at_the_first_call" else 5)
    assert res["window_s"] > 0
    assert res["numbers"] == whole["numbers"]
    assert compare.verdict(res["numbers"], c["limits"])
