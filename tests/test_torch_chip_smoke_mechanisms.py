"""The 32 px mechanism witness of chip_smoke.py (its phase 3b), run here
with the CPU on both sides: what a sound path reads against its limits,
and that wrong paths break them.

On the card one side runs K1 and cuFFT, the other the plain versions on
the CPU, and the card's ``cg_coords='auto'`` takes the pixel-space deblur
solver where the CPU's takes the Fourier one. Here the "card" side is the
CPU again, with the pixel solver and every denoiser output multiplied by
(1 + 1e-6 N(0, 1)), a stand-in for another device's rounding; each of its
guided calls starts from the CPU side's x_t and mechanism state, as on the
card.

The readings these tests print are the ones PERF.md (section 6) quotes
beside the limits."""
import numpy as np
import pytest

import chip_smoke as cs
from free_hunch_tpu_torch.guidance import mechanisms, solvers
from tests._torch_parity import one_thread  # noqa: F401

NUDGE = 1e-6


@pytest.fixture(scope="module")
def ref():
    return cs.MechanismReference(0)


_CPU = {}


def _cpu(ref, mech, op):
    if (mech, op) not in _CPU:
        _CPU[mech, op] = ref.run(mech, op, "cpu")
    return _CPU[mech, op]


def _card_side(ref, monkeypatch, mech, op, patches=()):
    """The "card" run: pixel coordinates, nudged denoiser, and ``patches``
    ((module or dict, name, replacement)) in force."""
    cpu = _cpu(ref, mech, op)
    with monkeypatch.context() as mp:
        mp.setattr(solvers, "deblur_mat_cg_fourier", solvers.deblur_mat_cg)
        for where, name, fn in patches:
            if isinstance(where, dict):
                mp.setitem(where, name, fn)
            else:
                mp.setattr(where, name, fn)
        card = ref.run(mech, op, "cpu", teacher=cpu, nudge=NUDGE)
    return cpu, card


@pytest.mark.parametrize("mech,op", cs.MECH_REF_CASES)
def test_sound_paths_read_inside_the_limits(ref, monkeypatch, mech, op):
    cpu, card = _card_side(ref, monkeypatch, mech, op)
    err, limit, bad = cs.mechanism_reference_failures(cpu, card)
    print(mech, op, (err / limit).round(4).tolist(), [c["niter"] for c in card["calls"]])
    assert bad == []
    assert card["launches"] == cpu["launches"] == 0


def _closed_form_without_mask(operator, y, x0_mean, theta0_var, return_u=False):
    """Inpainting's scalar-variance solve with the unobserved pixels' data
    term left in."""
    sigma_s = float(np.float32(operator.sigma_s))
    mat = (y - x0_mean) / (sigma_s**2 + theta0_var)
    return (mat, mat) if return_u else mat


WRONG = {
    # PiGDM's MLE variance sigma^2 / (1 + sigma^2) taken as sigma^2
    "pigdm_variance_without_the_mle_factor": (
        "pigdm", "gaussian_blur",
        [(mechanisms, "_mle_var", lambda sigma: float(np.float32(sigma) ** 2))]),
    # the inpainting closed form (PiGDM's solve) without the mask
    "inpainting_closed_form_without_the_mask": (
        "pigdm", "inpainting",
        [(solvers._CLOSED, "inpainting", _closed_form_without_mask)]),
}


@pytest.mark.parametrize("wrong", sorted(WRONG))
def test_wrong_paths_break_the_limits(ref, monkeypatch, wrong):
    mech, op, patches = WRONG[wrong]
    cpu, card = _card_side(ref, monkeypatch, mech, op, patches)
    err, limit, bad = cs.mechanism_reference_failures(cpu, card)
    print(wrong, (err / limit).round(4).tolist(), bad)
    assert bad, (err / limit)
