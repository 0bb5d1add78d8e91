"""Phase 8a's precision controls of chip_smoke.py (``LG_CONTROLS``: the
vjp run with the DCT's matmul operands rounded to bf16's and TF32's
mantissa bits) with the CPU in place of the card, on the CPU tests'
(3, 8, 8) images: each control breaks some limit of ``LG_LIMITS``, so the
phase, which fails on a control that reads inside every limit, passes.

The readings these tests print are the CPU's; the card's are in PERF.md."""
import pytest

import chip_smoke as cs
from tests._torch_parity import one_thread  # noqa: F401

SHAPE = (3, 8, 8)


@pytest.mark.parametrize("control", list(cs.LG_CONTROLS), ids=lambda c: c.split()[-1])
def test_precision_controls_break_the_limits(control):
    stats, _, bad = cs.linear_gaussian_oracle(0, "cpu", shape=SHAPE, runs=(control,))
    broken = cs.limits_broken(control, stats[control])
    print(control, broken)
    assert bad == [] and broken, (bad, stats)
