"""The 32 px witness of chip_smoke.py's phase 5a (the port's evaluation
driver, card against CPU), run here with the CPU on both sides: what a
sound path reads against its limits, and that wrong paths break them.

The "card" side is the CPU again with every denoiser output multiplied by
(1 + 1e-6 N(0, 1)), a stand-in for another device's rounding. The wrong
paths: a decode that truncates where it should round half to even, metric
totals that average the per-batch means instead of weighting them by the
batch's images, and TF32-like noise (1e-3 relative) on the LPIPS network's
features.

The readings these tests print are the ones PERF.md (section 6) quotes
beside the limits."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from free_hunch_tpu_torch import eval as teval
from free_hunch_tpu_torch.data import encoders
from free_hunch_tpu_torch.metrics import lpips as lpips_mod
from tests._torch_parity import one_thread  # noqa: F401

NUDGE = 1e-6
_CPU = {}


@pytest.fixture(scope="module")
def dref(tmp_path_factory):
    return cs.DriverReference(0, tmp_path_factory.mktemp("driver"))


def _sides(dref, monkeypatch, name, patches=()):
    if "cpu" not in _CPU:
        _CPU["cpu"] = dref.run("cpu", "cpu")
    with monkeypatch.context() as mp:
        for where, attr, fn in patches:
            mp.setattr(where, attr, fn)
        card = dref.run("cpu", name, nudge=NUDGE)
    return _CPU["cpu"], card


def test_sound_path_reads_inside_the_limits(dref, monkeypatch):
    cpu, card = _sides(dref, monkeypatch, "sound")
    ratio, bad = cs.driver_reference_failures(cpu, card)
    print("driver sound", {k: round(v, 5) for k, v in ratio.items()})
    assert bad == [] and max(ratio.values()) < 0.5
    assert card["launches"] == cpu["launches"] == 0
    assert len(cpu["records"]) == 2 and [r["n"] for r in cpu["records"]] == [2, 1]
    assert len(cpu["niter"]) == 2 and all(len(n) == 5 for n in cpu["niter"])
    assert "images/000002_000000.png" in cpu["files"]
    # the driver draws on the CPU: a second run reads the same, bit for bit
    again = dref.run("cpu", "again")
    assert again["records"] == cpu["records"]
    assert all(np.array_equal(a, b) for a, b in zip(again["samples"], cpu["samples"]))


def _truncating_decode(self, z):
    return torch.clamp((torch.as_tensor(z).float() + 1.0) * 127.5, 0, 255).to(torch.uint8)


def _unweighted_add(self, batch_size, **means):
    for n, v in means.items():
        self.sums[n] += float(v)
    self.count += 1


def _tf32_taps(self, x, taps=lpips_mod.LPIPS._vgg_taps):
    rng = np.random.default_rng(3)
    return [t * (1 + 1e-3 * torch.as_tensor(rng.normal(size=tuple(t.shape)), dtype=t.dtype))
            for t in taps(self, x)]


@pytest.mark.parametrize("name,patch,caught", [
    ("truncating_decode", (encoders.StandardRGBEncoder, "decode", _truncating_decode),
     "psnr"),
    ("per_batch_means", (teval.MetricAccumulator, "add", _unweighted_add), "totals"),
    ("tf32_lpips", (lpips_mod.LPIPS, "_vgg_taps", _tf32_taps), "lpips"),
])
def test_wrong_paths_break_the_limits(dref, monkeypatch, name, patch, caught):
    cpu, card = _sides(dref, monkeypatch, name, patches=[patch])
    ratio, bad = cs.driver_reference_failures(cpu, card)
    print("driver", name, {k: round(v, 3) for k, v in ratio.items()})
    assert bad and any(caught in b for b in bad), bad
