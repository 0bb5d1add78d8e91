"""The ``ncsnpp`` family (``reference/ncsnpp.py``, ``program/ncsnpp.py``)
through the harness on the CPU, its cell cut to a small NCSN++ with every
block kind (4 levels at 32 px, ``nf`` 8, attention at 8 px, both
pyramids, FIR resampling, the Fourier embedding): two images, eight Heun
steps, the torso in the reference's type, so that only a fault reads off.
Sound, the run reads correct; with the program's output scaled by 1 +
1e-3, not correct. The frozen counts against a hand count of the preset,
and ``fir_inputs`` against the calls the program makes."""
import time

import pytest
import torch

from _tiny import BENCH

import harness  # noqa: E402
import run  # noqa: E402
import spec  # noqa: E402

CELL = "ffhq1024-blur-vjp"
TINY = dict(image_size=32, nf=8, ch_mult=[1, 2, 2, 2], attn_resolutions=[8])
SEED = 2 ** 31 + 4242


def tiny_cell():
    c = spec.cell(CELL)
    c["config"]["model"].update(TINY)
    c["config"]["precision"]["torso"] = "float32"
    c["traffic"].update(batch=2, steps=8, trace={"first_call": 2, "calls": 3})
    # a float32 torso's limits (the toy family's): the cell's own leave a
    # bf16 torso its rounding, about 1e-2 of sigma F, which hides a 1e-3
    # fault; sound here, unet reads about 2e-6 and guide 5e-8
    c["limits"].update(unet=1e-4, guide=1e-6)
    return c


def run_tiny(traced):
    torch.set_num_threads(2)
    c = tiny_cell()
    res = harness.run_cell(c, SEED, 0.0, traced, time.time(), device="cpu",
                           cache_dir=BENCH.parent / ".bench_cache" / "data")
    return c, res, run.result_line(c, spec.benchmark(), res, traced, "cpu", 1)


def test_the_family_runs_and_reads_correct():
    c, res, line = run_tiny(True)
    assert line["correct"] and line["failed"] == 0, res["numbers"]
    assert set(res["numbers"]) == set(c["limits"])
    assert res["norm_bytes"]["k1_calls"] > 0 and res["norm_bytes"]["bwd_calls"] > 0
    assert line["metrics"]["fir_roofline"]["value"] > 0


def test_a_fault_in_the_program_reads_not_correct(monkeypatch):
    from free_hunch_tpu_torch.models import ncsnpp
    real = ncsnpp.NCSNpp.forward
    monkeypatch.setattr(ncsnpp.NCSNpp, "forward",
                        lambda self, x, sigma: real(self, x, sigma) * (1 + 1e-3))
    _, res, line = run_tiny(False)
    assert not line["correct"], res["numbers"]


def conv(cin, cout, k, side):
    return 2 * cin * cout * k * k * side * side


def fir_down(c, side):   # 16 taps an output sample, side / 2 squared of them
    return 2 * 16 * c * (side // 2) ** 2


def fir_up(c, side):     # 4 taps an output sample, (2 side) squared of them
    return 2 * 4 * c * (2 * side) ** 2


def test_forward_flops_is_a_hand_count_of_the_preset():
    """The preset layer by layer: channels 8, 16, 16, 16 at 32, 16, 8, 4 px,
    one block a level, attention at 8 px and in the middle; the embedding,
    attention's logits and the output pyramid in float32."""
    fam = spec.reference(tiny_cell()["config"])
    arch = fam.arch_of(tiny_cell()["config"]["model"])
    d = 2 * 32                                                    # each block's dense layer
    bf = [conv(3, 8, 3, 32),                                      # conv_in
          conv(8, 8, 3, 32) * 2 + 2 * 32 * 8,                     # 32 px block
          2 * fir_down(8, 32) + conv(8, 8, 3, 16) * 2 + d * 8 + conv(8, 8, 1, 16),   # down
          fir_down(3, 32) + conv(3, 8, 1, 16),                    # input pyramid, Combine
          conv(8, 16, 3, 16) + conv(16, 16, 3, 16) + d * 16 + conv(8, 16, 1, 16),
          2 * fir_down(16, 16) + conv(16, 16, 3, 8) * 2 + d * 16 + conv(16, 16, 1, 8),
          fir_down(3, 16) + conv(3, 16, 1, 8),
          conv(16, 16, 3, 8) * 2 + d * 16,                        # 8 px block
          4 * 2 * 64 * 16 * 16 + 2 * 64 * 64 * 16,                # its attention
          2 * fir_down(16, 8) + conv(16, 16, 3, 4) * 2 + d * 16 + conv(16, 16, 1, 4),
          fir_down(3, 8) + conv(3, 16, 1, 4),
          conv(16, 16, 3, 4) * 2 + d * 16,                        # 4 px block
          2 * (conv(16, 16, 3, 4) * 2 + d * 16),                  # the middle's blocks
          4 * 2 * 16 * 16 * 16 + 2 * 16 * 16 * 16,                # and attention
          # up, 4 px: two blocks on 32 channels, the up block to 8 px
          2 * (conv(32, 16, 3, 4) + conv(16, 16, 3, 4) + d * 16 + conv(32, 16, 1, 4)),
          2 * fir_up(16, 4) + conv(16, 16, 3, 8) * 2 + d * 16 + conv(16, 16, 1, 8),
          # 8 px: two blocks on 32, attention, the up block to 16 px
          2 * (conv(32, 16, 3, 8) + conv(16, 16, 3, 8) + d * 16 + conv(32, 16, 1, 8)),
          4 * 2 * 64 * 16 * 16 + 2 * 64 * 64 * 16,
          2 * fir_up(16, 8) + conv(16, 16, 3, 16) * 2 + d * 16 + conv(16, 16, 1, 16),
          # 16 px: blocks on 32 and 24 channels, the up block to 32 px
          conv(32, 16, 3, 16) + conv(16, 16, 3, 16) + d * 16 + conv(32, 16, 1, 16),
          conv(24, 16, 3, 16) + conv(16, 16, 3, 16) + d * 16 + conv(24, 16, 1, 16),
          2 * fir_up(16, 16) + conv(16, 16, 3, 32) * 2 + d * 16 + conv(16, 16, 1, 32),
          # 32 px: blocks on 24 and 16 channels to 8
          conv(24, 8, 3, 32) + conv(8, 8, 3, 32) + d * 8 + conv(24, 8, 1, 32),
          conv(16, 8, 3, 32) + conv(8, 8, 3, 32) + d * 8 + conv(16, 8, 1, 32)]
    f32 = [2 * 8 + 2 * 16 * 32 + 2 * 32 * 32,                       # Fourier, dense layers
           2 * 64 * 64 * 16, 2 * 16 * 16 * 16, 2 * 64 * 64 * 16,   # logits
           conv(16, 3, 3, 4), conv(16, 3, 3, 8) + fir_up(3, 4),    # the output pyramid
           conv(16, 3, 3, 16) + fir_up(3, 8), conv(8, 3, 3, 32) + fir_up(3, 16)]
    assert fam.forward_flops(arch, "bfloat16", 2) == {"float32": 2 * sum(f32),
                                                      "bfloat16": 2 * sum(bf)}
    # the pullback: no embedding, no dense layers (neither depends on the
    # input), attention's two matmuls twice (the logits' and weights @ v's
    # counts are equal); 20 blocks, their widths
    widths = [8, 16, 16, 16, 8, 16, 16] + [16, 16] + [16, 16, 16] * 3 + [8, 8]
    attn = sum(f32[1:4])
    assert fam.input_backward_flops(arch, "bfloat16", 1) == {
        "float32": sum(f32) - f32[0] + attn,
        "bfloat16": sum(bf) - sum(d * c for c in widths) + attn}


@pytest.mark.parametrize("remat", [False, True])
def test_fir_inputs_are_the_programs_calls(remat):
    from free_hunch_tpu_torch.models import ncsnpp
    from free_hunch_tpu_torch.utils import profiling
    cfg = tiny_cell()["config"]
    fam = spec.reference(cfg)
    model = ncsnpp.create_model(dtype=torch.float32, remat=remat, **cfg["model"])
    x = torch.rand(1, 3, 32, 32, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        with torch.no_grad():
            model(x, torch.ones(1))
        fwd = profiling.snapshot()
        profiling.reset()
        torch.autograd.grad(model(x, torch.ones(1)).sum(), x)
        pull = profiling.snapshot()
    n = len(fam.fir_inputs(fam.arch_of(cfg["model"])))
    assert fwd["counts"]["fir_calls"] == fwd["calls"]["fir.resample"] == n == 18
    assert pull["calls"]["fir.resample_backward"] == n
    # a remat'd block resamples again in the pullback: 12 of the 18 calls
    assert pull["calls"]["fir.resample"] == n + (12 if remat else 0)
