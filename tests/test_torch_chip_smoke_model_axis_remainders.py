"""``chip_smoke.py``'s phases 7c-7e (the model axis's remainders) rehearsed
on the CPU at 32 px, beside ``tests/test_torch_chip_smoke_model_axis.py``'s
7a and 7b, and the limits ``int8_axis_failures``,
``ragged_axis_failures`` and ``ddnm_axis_failures`` hold them to.

* 7c, ``int8_axis_rank`` in a gloo world of two (the tiny setup, fused
  int8, batch 2, 3 Heun steps as the CPU rehearsal runs it; the card 2):
  each guided call against rank 0's
  unsharded int8 replay well inside ``MA_INT8_CALL_REL_RMS``, equal CG
  counts, the ranks' x0 equal; K2's shard check with the plain twin in the
  kernels' place reads 0, and its control, the flagged route with each
  rank's own abs-max, reads the scale outside ``K2S_SCALE_REL`` at every
  K2 shape. The launch check fails, as it should without kernels; with
  launches equal to the hooks it passes, and one launch short it fails.
* 7d, ``ragged_axis_rank`` in a world of three (f32; 32 rows as 12, 10,
  10): the denoiser's and the raw UNet's outputs and the raw vjp well
  inside their limits (f32: the torso's distance from f32 is 0, so the
  vjp's limit is ``MA_DENOISED_REL_RMS``), and without halos well
  outside.
* 7e, DDNM+ through the driver as ``data:1,model:2`` against the world of
  one (two bundled images, inpainting, 4 steps): the final samples well
  inside ``MA_DDNM_REL_RMS``, PSNR and SSIM inside their limits; without
  halos the samples read outside.

The readings printed here are the ones PERF.md quotes beside the limits."""
import copy
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke as cs
from tests import _torch_sharded as ts
from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_chip_smoke_model_axis import SETUP32, _driver_args


def _world(tmp, mode, world, wrong=None, **inputs):
    setup = tmp / "setup32.txt"
    setup.write_text(SETUP32)
    torch.save(dict(setup=setup, wrong=wrong, **inputs), tmp / "inputs.pt")
    procs = [subprocess.Popen([sys.executable, ts.WORKER, mode, str(r), str(world),
                               str(tmp / "store"), str(tmp), f"data:1,model:{world}"],
                              cwd=ts.ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    ts.wait_all(procs, f"{mode} rehearsal ({wrong or 'sound'})")


@pytest.fixture(scope="module")
def int8_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke7c")
    _world(tmp, "smoke7c", 2)
    return [torch.load(tmp / f"int8_rank{r}.pt", weights_only=False) for r in range(2)]


def test_7c_sound_path_reads_inside_the_limits_and_the_control_outside(int8_ranks):
    read, bad = cs.int8_axis_failures(int8_ranks)
    print("7c sound", read)
    assert read["same"] and read["niter"] == read["ref_niter"] and len(read["errs"]) == 5
    assert max(read["errs"]) < 0.5 * cs.MA_INT8_CALL_REL_RMS
    rows = int8_ranks[0]["k2_rows"]
    assert rows and all(r["code_diff"] == 0 and r["scale_rel"] == 0 for _, r in rows)
    assert read["control"] and min(read["control"]) > 10 * cs.K2S_SCALE_REL
    # without kernels the CPU launches none: only the launch check fails
    assert bad and all("launches" in b for b in bad), bad


def test_7c_launch_counting_passes_when_each_call_launches_once(int8_ranks):
    ranks = copy.deepcopy(int8_ranks)
    for r in ranks:
        hk = r["hooks"]
        r["launches"] = dict(k1=dict(stats=hk["gn"], apply=hk["gn"]),
                             k2=dict(stats=hk["gnq"], merge=hk["gnq"], apply=hk["gnq"]),
                             groupnorm_silu=0, gn_silu_quant=0,
                             int8_conv=hk["int8"] + hk["pullback"])
    assert cs.int8_axis_failures(ranks)[1] == []
    ranks[1]["launches"]["k2"]["merge"] -= 1
    assert cs.int8_axis_failures(ranks)[1]


@pytest.mark.parametrize("wrong", [None, "no_halo"])
def test_7d_ragged_forward_and_vjp_against_the_unsharded_model(tmp_path, wrong):
    _world(tmp_path, "smoke7d", cs.MA_RAGGED_WORLD, wrong)
    ranks = [torch.load(tmp_path / f"ragged_rank{r}.pt", weights_only=False)
             for r in range(cs.MA_RAGGED_WORLD)]
    read, bad = cs.ragged_axis_failures(ranks)
    print("7d", wrong or "sound", read, ranks[0]["plan"])
    assert ranks[0]["plan"][0] == (12, 10, 10) and read["same"]
    if wrong is None:
        assert max(read[k] for k in ("d", "y", "gx")) < 0.01 * cs.MA_DENOISED_REL_RMS
        assert bad and all("K1 launches" in b for b in bad), bad
    else:
        assert min(read["d"], read["y"], read["gx"]) > 2 * cs.MA_DENOISED_REL_RMS
        assert read["gx"] > read["gx_limit"] and bad


def _ddnm_args(tmp, name, mesh_shape):
    args = _driver_args(tmp, name, mesh_shape)
    args.update(conditioning_mechanism="ddnm", operator_name="inpainting", num_steps=4)
    return args


@pytest.fixture(scope="module")
def ddnm_one(tmp_path_factory):
    """7e's world of one at 32 px, in this process, kept as 7e keeps it."""
    from free_hunch_tpu_torch import config as tcfg
    from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator
    args = _ddnm_args(tmp_path_factory.mktemp("ddnm_one"), "one", "data:1")
    kept = {"d": [], "x0": [], "x": [], "niter": []}
    with cs.keeping_samples(kept):
        one = DDNMEvaluator(tcfg.load_config(args=args), device="cpu").run()
    return one, [t.numpy() for t in kept["x"]]


@pytest.mark.parametrize("wrong", [None, "no_halo"])
def test_7e_ddnm_under_a_model_axis_against_the_world_of_one(tmp_path, ddnm_one, wrong):
    _world(tmp_path, "smoke7b", 2, wrong, args=_ddnm_args(tmp_path, "ma", cs.MA_MESH))
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    journals = sorted(p.name for p in (tmp_path / "ma").glob("metrics_rank*.jsonl"))
    ma = dict(results=outs[0]["results"], samples=[o["samples"] for o in outs], probes=[],
              journals=journals)
    one, one_x = ddnm_one
    read, bad = cs.ddnm_axis_failures(ma, one, one_x)
    print("7e", wrong or "sound", read)
    assert read["same"]
    if wrong is None:
        assert bad == [] and read["final"] < 0.5 * cs.MA_DDNM_REL_RMS
    else:
        assert read["final"] > cs.MA_DDNM_REL_RMS and bad


def test_7e_launch_check_fails_where_a_rank_misses_its_hooks():
    import numpy as np
    x = [np.ones((2, 3, 4, 4), np.float32)]
    ma = dict(results=dict(images=2, psnr=10.0, ssim=0.1), samples=[dict(x=x), dict(x=x)],
              journals=["metrics_rank00.jsonl"],
              probes=[dict(rank=r, launches=0, hooks=60, sharded=dict(stats=60, apply=60))
                      for r in range(2)])
    one = dict(psnr=10.0, ssim=0.1)
    assert cs.ddnm_axis_failures(ma, one, x)[1] == []
    ma["probes"][1]["sharded"]["apply"] = 59
    assert cs.ddnm_axis_failures(ma, one, x)[1]
