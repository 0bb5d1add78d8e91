"""The port's evaluation driver on its own (``free_hunch_tpu_torch/eval.py``,
``generate_conditional.py``), at 32 px on the bundled images as in
``tests/test_torch_eval.py``, whose setup and options it shares: the
resume journal and FID replay with Free Hunch on the gaussian blur, the
int8_static calibration and its cache, the command line's DDNM+ step
doubling, the default device, and the paths that raise until the
multi-process driver exists."""
import json
import os

import numpy as np
import pytest
import torch

from free_hunch_tpu_torch import config as tcfg
from free_hunch_tpu_torch import eval as teval
from free_hunch_tpu_torch.eval import Evaluator as TEvaluator
from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator as TDDNMEvaluator
from free_hunch_tpu_torch.generate_conditional import cmdline
from free_hunch_tpu_torch.metrics import fid as tfid
from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_eval import DATA, RES, SETUP32, _args


@pytest.fixture(scope="module")
def setup32(tmp_path_factory):
    p = tmp_path_factory.mktemp("models") / "setup32.txt"
    p.write_text(SETUP32)
    return str(p)


def _fh_args(tmp_path, setup32, **over):
    kw = dict(conditioning_mechanism="online_covariance", operator_name="gaussian_blur",
              image_base_covariance="dct_diagonal_noinfo", num_steps=3, noise_sigma=0.1)
    return _args(tmp_path, setup32, "fh", **dict(kw, **over))


def test_resume_reproduces_the_journal_and_fid_replays(tmp_path, setup32, monkeypatch):
    """Free Hunch on the gaussian blur, port only: an uninterrupted run; then
    the last journal record and its PNGs are deleted and a resumed run
    recomputes that batch: the journal is byte for byte the uninterrupted
    run's, and the FID statistics are the same, batch 1's re-extracted from
    its saved PNGs, to 1e-4 relative (the f32 Inception features of the
    same pixels, whose CPU convolutions may sum in another order on another
    allocation: observed 1.5e-5). The Frechet distance itself, a 2048^2
    sqrtm, is held in tests/test_torch_metrics.py; here compute_fid
    records its input."""
    seen = []
    monkeypatch.setattr(tfid, "compute_fid", lambda st, ref: seen.append(
        (st.n, st.s.copy(), st.ss.copy())) or float(np.trace(st.ss)))
    extract, _ = tfid.make_extractor(device="cpu")
    st = tfid.FeatureStats()
    st.add(extract(torch.rand((2, 3, RES, RES)) * 2 - 1))
    st.save(str(tmp_path / "ref.npz"), is_proxy=True)
    args = _fh_args(tmp_path, setup32, fid_ref_stats=str(tmp_path / "ref.npz"))
    first = TEvaluator(tcfg.load_config(args=args), device="cpu").run()
    out = tmp_path / "fh"
    journal = out / "metrics_rank00.jsonl"
    whole = journal.read_bytes()
    lines = whole.decode().splitlines(keepends=True)
    assert len(lines) == 2 and first["resumed_batches"] == 0 and "fid" in first
    journal.write_text(lines[0])
    for name in json.loads(lines[1])["batch"].split("|"):
        for sub in ("images", "cond_images", "forward_images"):
            os.remove(out / sub / f"{name}.png")
    again = TEvaluator(tcfg.load_config(args=dict(args, resume=True)), device="cpu").run()
    assert journal.read_bytes() == whole
    assert again["resumed_batches"] == 1 and again["fid_is_proxy"] is True
    for k in ("psnr", "ssim", "lpips"):
        assert again[k] == pytest.approx(first[k], rel=1e-12)
    (n1, s1, ss1), (n2, s2, ss2) = seen
    assert n1 == n2 == 3
    np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-4 * np.abs(s1).max())
    np.testing.assert_allclose(ss2, ss1, rtol=1e-4, atol=1e-4 * np.abs(ss1).max())
    assert sorted(os.listdir(out / "images")) == [f"00000{i}_000000.png" for i in range(3)]


def test_a_resumed_run_without_its_pngs_recomputes_for_fid(tmp_path, setup32, monkeypatch):
    """A journaled batch whose PNGs are gone (pruned) is recomputed when FID
    needs its features, and its record is not written twice."""
    monkeypatch.setattr(tfid, "compute_fid", lambda st, ref: float(st.n))
    extract, _ = tfid.make_extractor(device="cpu")
    st = tfid.FeatureStats()
    st.add(extract(torch.zeros((2, 3, RES, RES))))
    st.save(str(tmp_path / "ref.npz"), is_proxy=True)
    args = _fh_args(tmp_path, setup32, fid_ref_stats=str(tmp_path / "ref.npz"),
                    total_images=2, num_steps=2)
    TEvaluator(tcfg.load_config(args=args), device="cpu").run()
    out = tmp_path / "fh"
    whole = (out / "metrics_rank00.jsonl").read_bytes()
    os.remove(out / "images" / "000001_000000.png")
    res = TEvaluator(tcfg.load_config(args=dict(args, resume=True)), device="cpu").run()
    assert res["resumed_batches"] == 0 and res["fid"] == 2.0
    assert (out / "metrics_rank00.jsonl").read_bytes() == whole


def test_cmdline_ddnm_doubles_the_heun_steps(tmp_path, setup32):
    argv = [f"--outdir={tmp_path / 'cli'}", f"--openai_setup_path={setup32}",
            f"--openai_state_dict_path={tmp_path / 'missing.pt'}", "--allow_random_init=true",
            f"--dataset_path={DATA}", "--total_images=1", "--batch_size=1",
            "--num_steps=2", "--conditioning_mechanism=ddnm", "--operator_name=gaussian_blur",
            "--dtype=float32", "--mesh_shape=data:1"]
    res = cmdline(argv, device="cpu")
    with open(tmp_path / "cli" / "config.json") as f:
        assert json.load(f)["num_steps"] == 4
    log = (tmp_path / "cli" / "output.log").read_text()
    assert "PSNR:" in log and np.isfinite(res["psnr"])
    with pytest.raises(SystemExit):
        cmdline(argv[:1] + ["--conditional=false"], device="cpu")


def test_the_entry_points_default_to_the_card(tmp_path, setup32, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEvaluator(tcfg.load_config(args=_args(tmp_path, setup32, "nocard")))
    with pytest.raises(RuntimeError, match="CUDA"):
        TDDNMEvaluator(tcfg.load_config(args=_args(tmp_path, setup32, "nocard")))


@pytest.mark.parametrize("over,match", [(dict(mesh_shape="data:4,model:2"), "item 15"),
                                        (dict(quant="int8_static",
                                              conditioning_mechanism="ddnm"), "ddnm")])
def test_paths_not_ported_raise(tmp_path, setup32, over, match):
    cls = TDDNMEvaluator if over.get("conditioning_mechanism") == "ddnm" else TEvaluator
    with pytest.raises((NotImplementedError, ValueError), match=match):
        cls(tcfg.load_config(args=_args(tmp_path, setup32, "x", **over)), device="cpu")


def test_metric_accumulator_weights_by_samples():
    acc = teval.MetricAccumulator("psnr")
    acc.add(2, psnr=10.0)
    acc.add(1, psnr=16.0)
    assert acc.means()["psnr"] == pytest.approx(12.0) and acc.count == 3


def test_int8_static_calibrates_once_and_caches(tmp_path, setup32, monkeypatch):
    """quant='int8_static': the driver calibrates the activation scales by
    replaying the sampler (models/calibrate.py), caches the table beside
    the checkpoint path keyed by the schedule and operator, and a second
    driver reads the cache instead of calibrating again."""
    from free_hunch_tpu_torch.models import calibrate

    ckpt = str(tmp_path / "absent.pt")
    args = _fh_args(tmp_path, setup32, quant="int8_static", qscale_calib_draws=1,
                    num_steps=2, total_images=1, openai_state_dict_path=ckpt)
    first = TEvaluator(tcfg.load_config(args=args), device="cpu")
    cached = [f for f in os.listdir(tmp_path) if ".qscales." in f]
    assert len(cached) == 1 and "gaussian_blur" in cached[0]
    assert first.precond.qscales is not None
    res = first.run()
    assert np.isfinite(res["psnr"])
    monkeypatch.setattr(calibrate, "calibrate_qscales", None)  # must not be called
    again = TEvaluator(tcfg.load_config(args=args), device="cpu")
    for a, b in zip(again.precond.qscales[1].values(), first.precond.qscales[1].values()):
        assert np.array_equal(a, b)
