"""On the card only (marker ``cuda``; each skips itself where torch sees no
card): a short run of a cell at its full size reads correct, and the
control at full size reads not correct.

    python3 -m pytest -q -m cuda benchmark/tests/test_benchmark_card.py
"""
import json
import subprocess
import sys

import pytest
import torch

from _tiny import BENCH

CELLS = ("imagenet256-inpaint-covgrad", "ffhq256-blur-vjp")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees none")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    need_card()
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed",
                        "2147483659", "--seconds", "25", "--trace", "0"],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_full_size(cell):
    need_card()
    import compare
    import control
    import harness
    import inputs
    import spec
    import weights as weights_mod
    c = spec.cell(cell)
    dev = torch.device("cuda")
    fam = spec.reference(c["config"])
    arch = fam.arch_of(c["config"]["model"])
    w = weights_mod.make(fam.param_shapes(arch), 11, dev, c["config"]["precision"])
    prog = harness.Program(c, w, dev)
    ctl = harness.Program(c, w, dev, quant="int8") if c["check"]["control_torso"] == "int8" \
        else None
    images = inputs.bundled_images(spec.ROOT / ".bench_cache" / "data")
    r = control.seed_readings(c, 2147483663, prog, ctl, images, dev, True)
    assert compare.verdict(r["program"], c["limits"]), r["program"]
    assert not compare.verdict(r["control"], c["limits"]), r["control"]
