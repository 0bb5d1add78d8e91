"""``chip_smoke.py``'s phase 7 (the model axis) rehearsed on the CPU: its
rank body ``model_axis_rank`` in a gloo world of two at 32 px (the tiny
setup in bf16, batch 2, 3 Heun steps; the 256 px run stays on the card),
and the limits ``model_axis_failures`` and ``model_axis_driver_failures``
hold it to.

* Sound: every guided call's x0, sharded against the unsharded mechanism
  on rank 0 from the same inputs and state, reads well inside
  ``MA_CALL_REL_RMS``, and the free-running final sample inside
  ``MA_FINAL_REL_RMS``; equal CG counts; equal weights and x0 on both
  ranks. The launch check fails, as it should without kernels: the CPU
  takes the plain sharded GroupNorm.
* Wrong: a shard that takes zero rows in place of its neighbours' halo
  breaks the limit.
* 7b at 32 px: the driver as ``data:1,model:2`` reads its first denoiser
  output well inside ``MA_DENOISED_REL_RMS`` of the world of one's, and
  well outside it without halos.
* 7b's limits: an image counted on both ranks, totals that differ between
  the ranks, a second journal, PSNR off the world of one, a first
  denoiser output off the world of one's, a missing guided call, outputs
  that differ between the ranks, and a rank whose K1 launches miss its
  hooks each fail.

The readings printed here are the ones PERF.md quotes beside the limits."""
import copy

import pytest

import chip_smoke as cs
from tests._torch_parity import one_thread  # noqa: F401
from tests._torch_sharded import run_world

SETUP32 = ("--channel_mult 1,2 --attention_resolutions 8 --class_cond False "
           "--diffusion_steps 1000 --dropout 0.0 --image_size 32 --learn_sigma True "
           "--noise_schedule linear --num_channels 32 --num_head_channels 16 "
           "--num_res_blocks 1 --resblock_updown True --use_fp16 False "
           "--use_scale_shift_norm True --use_new_attention_order False")


def _ranks(tmp, wrong=None):
    setup = tmp / "setup32.txt"
    setup.write_text(SETUP32)
    import torch
    d = tmp / f"smoke_{wrong}"
    d.mkdir()
    torch.save(dict(setup=setup, wrong=wrong), d / "inputs.pt")
    # run_world writes its own inputs; the rank body writes rank<r>.pt into d
    from tests import _torch_sharded as ts
    import subprocess
    import sys
    import os
    procs = [subprocess.Popen([sys.executable, ts.WORKER, "smoke7a", str(r), "2",
                               str(d / "store"), str(d), cs.MA_MESH], cwd=ts.ROOT,
                              env=dict(os.environ, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    ts.wait_all(procs, f"phase 7a rehearsal ({wrong or 'sound'})")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    return _ranks(tmp_path_factory.mktemp("sound"))


def test_sound_path_reads_inside_the_limits(sound):
    read, bad = cs.model_axis_failures(sound)
    print("7a sound", {k: v for k, v in read.items()})
    assert read["same"] and read["niter"] == read["ref_niter"] and len(read["errs"]) == 5
    assert max(read["errs"]) < 0.5 * cs.MA_CALL_REL_RMS
    assert read["final"] < cs.MA_FINAL_REL_RMS
    # without kernels the CPU launches none: only the launch check fails
    assert bad and all("K1 sharded launches" in b for b in bad), bad
    for r in sound:
        assert r["hooks"] > 0 and r["launches"] == {"stats": 0, "apply": 0}
        assert r["cov_shape"][-1] == 3 * 32 * 32 // 2
        assert all(c["collectives"] > 0 for c in r["calls"])


def test_launch_counting_passes_when_each_norm_launches_once(sound):
    ranks = copy.deepcopy(sound)
    for r in ranks:
        r["launches"] = {"stats": r["hooks"], "apply": r["hooks"]}
    assert cs.model_axis_failures(ranks)[1] == []
    ranks[1]["launches"]["apply"] -= 1
    assert cs.model_axis_failures(ranks)[1]


def test_dropping_the_halo_breaks_the_limit(tmp_path):
    read, bad = cs.model_axis_failures(_ranks(tmp_path, "no_halo"))
    print("7a no halo", read["errs"], read["final"])
    assert any("x0 relative RMS" in b for b in bad) and any("final sample" in b for b in bad)
    assert max(read["errs"]) > 2 * cs.MA_CALL_REL_RMS and read["final"] > cs.MA_FINAL_REL_RMS


def _driver_args(tmp, name, mesh_shape):
    """7b's options at 32 px (the tiny setup in bf16, 3 Heun steps)."""
    from tests.test_torch_eval import _args
    setup = tmp / "setup32.txt"
    setup.write_text(SETUP32)
    args = _args(tmp, str(setup), name, conditioning_mechanism="online_covariance",
                 operator_name="gaussian_blur", kernel_size=61, intensity=3.0,
                 image_base_covariance="dct_diagonal", cov_capacity="auto", num_steps=3,
                 total_images=2, batch_size=2, noise_sigma=0.1, dtype="bfloat16",
                 dataset_path=str(cs.ROOT / "data" / "imagenet"), mesh_shape=mesh_shape)
    args.pop("cg_maxiter")
    return args


@pytest.fixture(scope="module")
def driver_one(tmp_path_factory):
    """7b's world of one at 32 px, in this process, kept as 7b keeps it."""
    from free_hunch_tpu_torch import config as tcfg
    from free_hunch_tpu_torch import eval as teval
    args = _driver_args(tmp_path_factory.mktemp("one"), "one", "data:1")
    kept = {"d": [], "x0": [], "x": [], "niter": []}
    with cs.keeping_samples(kept):
        one = teval.Evaluator(tcfg.load_config(args=args), device="cpu").run()
    one["samples"] = {k: [t.numpy() for t in v] for k, v in kept.items()}
    return one


@pytest.mark.parametrize("wrong", [None, "no_halo"])
def test_driver_rehearsal_tells_a_shard_without_halos(tmp_path, driver_one, wrong):
    """7b's comparison at 32 px on the CPU: the driver as ``data:1,model:2``
    against the world of one reads the first denoiser output well inside
    ``MA_DENOISED_REL_RMS``, and without halos well outside it."""
    import subprocess
    import sys
    import os
    import torch
    from tests import _torch_sharded as ts
    torch.save(dict(args=_driver_args(tmp_path, "ma", cs.MA_MESH), wrong=wrong),
               tmp_path / "inputs.pt")
    procs = [subprocess.Popen([sys.executable, ts.WORKER, "smoke7b", str(r), "2",
                               str(tmp_path / "store"), str(tmp_path), cs.MA_MESH], cwd=ts.ROOT,
                              env=dict(os.environ, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    ts.wait_all(procs, f"phase 7b rehearsal ({wrong or 'sound'})")
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ma = dict(results=outs[0]["results"], samples=[o["samples"] for o in outs])
    read = cs.model_axis_driver_readings(ma, driver_one)
    print("7b", wrong or "sound", read)
    assert read["same"] and read["n_calls"] == (5, 5) and read["niter"][0] == read["niter"][1]
    if wrong is None:
        assert read["denoised"] < 0.5 * cs.MA_DENOISED_REL_RMS
    else:
        assert read["denoised"] > 2 * cs.MA_DENOISED_REL_RMS


def _driver_readings():
    results = dict(images=2, psnr=10.0, ssim=0.1, lpips=0.5)
    probes = [dict(rank=r, launches=0, hooks=90, sharded={"stats": 90, "apply": 90},
                   totals=dict(psnr=10.0, ssim=0.1, lpips=0.5, images=2)) for r in range(2)]
    read = dict(d_psnr=0.01, d_ssim=5e-4, denoised=0.5 * cs.MA_DENOISED_REL_RMS,
                calls=[0.04, 0.3], final=0.3, n_calls=(2, 2), same=True)
    return results, probes, ["metrics_rank00.jsonl"], dict(psnr=10.01, ssim=0.1005), read


@pytest.mark.parametrize("wrong", [None, "counted_twice", "ranks_differ", "two_journals",
                                   "psnr_off", "launches_miss", "denoiser_off",
                                   "calls_missing", "samples_differ"])
def test_driver_limits(wrong):
    results, probes, journals, one, read = _driver_readings()
    if wrong == "counted_twice":
        results["images"] = 4
    elif wrong == "ranks_differ":
        probes[1]["totals"]["psnr"] = 10.5
    elif wrong == "two_journals":
        journals.append("metrics_rank01.jsonl")
    elif wrong == "psnr_off":
        read["d_psnr"] = 2 * cs.MA_PSNR_ABS
    elif wrong == "launches_miss":
        probes[0]["sharded"]["stats"] = 89
    elif wrong == "denoiser_off":
        read["denoised"] = 2 * cs.MA_DENOISED_REL_RMS
    elif wrong == "calls_missing":
        read["n_calls"] = (1, 2)
    elif wrong == "samples_differ":
        read["same"] = False
    bad = cs.model_axis_driver_failures(results, probes, journals, one, read)
    assert (bad == []) == (wrong is None), bad


def test_driver_readings_compare_rank0_with_the_world_of_one():
    import numpy as np
    x = np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 3, 2, 2)
    one = dict(psnr=10.0, ssim=0.1, samples=dict(d=[x, x], x0=[x, 2 * x], x=[x],
                                                 niter=[np.array(3), np.array(2)]))
    rank = dict(d=[x * 1.002, x], x0=[x * 1.01, 2 * x * 1.1], x=[x * 1.5],
                niter=[np.array(3), np.array(4)])
    ma = dict(results=dict(psnr=10.25, ssim=0.1), samples=[rank, dict(rank)])
    read = cs.model_axis_driver_readings(ma, one)
    assert np.allclose(read["calls"], [0.01, 0.1]) and abs(read["final"] - 0.5) < 1e-6
    assert abs(read["denoised"] - 0.002) < 1e-6
    assert read["same"] and read["n_calls"] == (2, 2) and read["niter"] == ([3, 4], [3, 2])
    assert abs(read["d_psnr"] - 0.25) < 1e-9 and read["d_ssim"] == 0
    ma["samples"][1] = dict(rank, d=[x, x])
    assert not cs.model_axis_driver_readings(ma, one)["same"]
