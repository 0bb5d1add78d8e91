"""The 32 px witness of chip_smoke.py's phase 3c (DDNM+ per step, Free
Hunch with f64 algebra and through the cosine preconditioner per guided
call), run here with the CPU on both sides: what a sound path reads
against its limits, and that wrong paths break them.

The "card" side is the CPU again, with every epsilon (DDNM+) or denoiser
output (Free Hunch) multiplied by (1 + 1e-6 N(0, 1)), a stand-in for
another device's rounding, and Free Hunch on the pixel-space deblur solver
that the card's ``cg_coords='auto'`` takes; each step or guided call starts
from the CPU side's inputs, as on the card.

The readings these tests print are the ones PERF.md (section 6) quotes
beside the limits."""
import numpy as np
import pytest

import chip_smoke as cs
from free_hunch_tpu_torch.guidance import solvers
from free_hunch_tpu_torch.operators import svd
from free_hunch_tpu_torch.samplers import ddnm
from tests._torch_parity import one_thread  # noqa: F401

NUDGE = 1e-6


@pytest.fixture(scope="module")
def dref():
    return cs.DDNMReference(0)


@pytest.fixture(scope="module")
def mref():
    return cs.MechanismReference(0)


_CPU = {}


def _ddnm_sides(dref, monkeypatch, op, patches=()):
    if op not in _CPU:
        _CPU[op] = dref.run(op, "cpu")
    with monkeypatch.context() as mp:
        for where, name, fn in patches:
            mp.setattr(where, name, fn)
        card = dref.run(op, "cpu", teacher=_CPU[op], nudge=NUDGE)
    return _CPU[op], card


@pytest.mark.parametrize("op", cs.DDNM_OPS)
def test_ddnm_sound_paths_read_inside_the_limits(dref, monkeypatch, op):
    cpu, card = _ddnm_sides(dref, monkeypatch, op)
    err, limit, bad = cs.ddnm_reference_failures(cpu, card)
    print("ddnm", op, (err / limit).round(5).tolist())
    assert bad == [] and len(err) == dref.steps
    assert card["launches"] == cpu["launches"] == 0
    # the CPU side's sampler and the per-step replay agree bit for bit
    exact = dref.run(op, "cpu", teacher=cpu)
    assert all(np.array_equal(a, b) for a, b in zip(exact["x_next"], cpu["x_next"]))


def _tiled(self):
    """Deblurring's singular values tiled over the channels, as upstream
    lays them out, in place of the interleaved layout of Vt."""
    return self._singulars.repeat(self.channels)


def _swap_one_step(steps_fn, k=3):
    def steps(*a, **kw):
        out = steps_fn(*a, **kw)
        out[k] = dict(out[k], at=out[k]["at_next"], at_next=out[k]["at"])
        return out
    return steps


WRONG = {
    "deblurring_tiled_not_interleaved": ("gaussian_blur", [(svd.Deblurring, "singulars",
                                                            _tiled)]),
    "alpha_bars_swapped_in_one_step": ("super_resolution",
                                       [(ddnm, "ddnm_steps", _swap_one_step(ddnm.ddnm_steps))]),
}


@pytest.mark.parametrize("wrong", sorted(WRONG))
def test_ddnm_wrong_paths_break_the_limits(dref, monkeypatch, wrong):
    op, patches = WRONG[wrong]
    cpu, card = _ddnm_sides(dref, monkeypatch, op, patches)
    err, limit, bad = cs.ddnm_reference_failures(cpu, card)
    print(wrong, (err / limit).round(3).tolist())
    assert bad, err / limit
    assert (err / limit).max() > 10


@pytest.mark.parametrize("mech,op", cs.FH_VARIANT_CASES)
def test_free_hunch_variants_read_inside_the_limits(mref, monkeypatch, mech, op):
    cpu = mref.run(mech, op, "cpu")
    with monkeypatch.context() as mp:
        mp.setattr(solvers, "deblur_mat_cg_fourier", solvers.deblur_mat_cg)
        card = mref.run(mech, op, "cpu", teacher=cpu, nudge=NUDGE)
    err, limit, bad = cs.mechanism_reference_failures(cpu, card)
    print(mech, op, (err / limit).round(4).tolist(), [c["niter"] for c in card["calls"]])
    assert bad == []
    precond = mref.models["cpu", cs.FH_VARIANTS[mech][1]]
    assert type(precond).__name__ == {"linear": "IDDPMLinearPrecond",
                                      "cosine": "IDDPMCosinePrecond"}[cs.FH_VARIANTS[mech][1]]
