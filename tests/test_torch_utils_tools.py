"""Port parity for the rest of ``utils`` and for the tools
(``free_hunch_tpu_torch/tools``): ``PhaseTimer``, ``annotate`` and
``trace`` on the CPU, ``persistence`` (and a JAX-package pickle read by
the port), ``open_url`` (local, ``file://``, the cache, a miss), and each
tool against the repository's JAX-bound script on the same inputs:
``dataset_tool`` convert, ``frequency_analysis``, ``image_visualisation``
(both on the bundled images at a small size), ``convert_lpips_weights``;
``count_flops`` is held exactly to a closed-form count of a 32 px UNet's
products and ``compute_fid_stats`` to the port's own extractor."""
import gzip
import hashlib
import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import PIL.Image
import pytest
import torch

from free_hunch_tpu_torch.data import png
from free_hunch_tpu_torch.data.dataset import ImageFolderDataset
from free_hunch_tpu_torch.tools import (compute_fid_stats, convert_lpips_weights, count_flops,
                                        dataset_tool, frequency_analysis, image_visualisation)
from free_hunch_tpu_torch.utils import dynamic, persistence, profiling
from tests._torch_parity import one_thread  # noqa: F401

# (not this file's __file__: the persistence tests exec this module's source,
# which has none)
ROOT = Path(persistence.__file__).resolve().parents[2]
BUNDLED = ROOT / "data" / "imagenet" / "00000"


def test_phase_timer_annotate_and_trace_on_the_cpu(tmp_path):
    pt = profiling.PhaseTimer()
    out = pt.measure("matmul", lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert out.shape == (64, 64) and float(out[0, 0]) == 64.0
    with pt.phase("empty"):
        pass
    with pt.phase("nested") as ph:
        ph.set({"a": [torch.ones(2)], "b": (torch.zeros(1), 3)})
    s = pt.summary()
    assert "matmul" in s and "empty" in s and "nested" in s
    assert pt.counts["nested"] == 1 and pt.totals["matmul"] > 0
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        with profiling.annotate("region_of_interest"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert any(e.key == "region_of_interest" for e in prof.key_averages())
    with gzip.open(tmp_path / "tr" / profiling.TRACE_FILE, "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region_of_interest" for e in events)
    assert profiling.device_memory_stats("cpu") is None


def test_the_card_entries_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_memory_stats()
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace("unused"):
            pass


def test_persistence_round_trip():
    @persistence.persistent_class
    class Thing:
        def __init__(self, a, b=2):
            self.a, self.b, self.derived = a, b, a * b

    t = Thing(3, b=4)
    t2 = persistence.loads(persistence.dumps(t))
    assert (t2.a, t2.b, t2.derived) == (3, 4, 12)
    assert persistence.is_persistent(t) and not persistence.is_persistent(object())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_persistence_rebuilds_a_vanished_module(tmp_path, writer):
    """A pickled object whose module has gone rebuilds from the embedded
    module source, base classes and module globals included; a pickle of
    the JAX package's copy reads in the port (the same format)."""
    import importlib
    pkg = {"port": "free_hunch_tpu_torch", "jax": "free_hunch_tpu"}[writer]
    mod_name = f"_persist_probe_{writer}"
    (tmp_path / f"{mod_name}.py").write_text(
        f"from {pkg}.utils import persistence as P\n"
        "SCALE = 10\n"
        "class Base:\n"
        "    def tag(self):\n"
        "        return 'base'\n"
        "@P.persistent_class\n"
        "class Derived(Base):\n"
        "    def __init__(self, a):\n"
        "        self.a = a\n"
        "        self.scaled = a * SCALE\n")
    sys.path.insert(0, str(tmp_path))
    try:
        mod = importlib.import_module(mod_name)
        blob = (persistence if writer == "port"
                else importlib.import_module("free_hunch_tpu.utils.persistence")).dumps(
                    mod.Derived(4))
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop(mod_name, None)
    (tmp_path / f"{mod_name}.py").unlink()
    obj = persistence.loads(blob)
    assert (obj.a, obj.scaled, obj.tag()) == (4, 40, "base")


def test_open_url_local_file_url_cache_and_miss(tmp_path):
    from free_hunch_tpu.utils import dynamic as jdyn
    p = tmp_path / "blob.bin"
    p.write_bytes(b"hello")
    with dynamic.open_url(str(p)) as f:
        assert f.read() == b"hello"
    with dynamic.open_url(f"file://{p}") as f:
        assert f.read() == b"hello"
    assert dynamic.open_url(f"file://{p}", return_filename=True) == str(p)
    url = "https://example.invalid/weights.npz"
    cache = tmp_path / "cache"
    cache.mkdir()
    with pytest.raises(IOError, match="downloads nothing"):
        dynamic.open_url(url, cache_dir=str(cache))
    hit = cache / f"{hashlib.md5(url.encode()).hexdigest()}_weights.npz"
    hit.write_bytes(b"cached")
    with dynamic.open_url(url, cache_dir=str(cache)) as f:
        assert f.read() == b"cached"
    for u in (str(p), f"file://{p}", url):
        assert dynamic.open_url(u, cache_dir=str(cache), return_filename=True) == \
            jdyn.open_url(u, cache_dir=str(cache), return_filename=True)


def _image_dir(tmp_path, n=3, size=(20, 24)):
    d = tmp_path / "src"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        PIL.Image.fromarray(rng.integers(0, 255, size + (3,), dtype=np.uint8)).save(
            d / f"img{i:04d}.png")
    return d


@pytest.mark.parametrize("transform,res,dest", [
    ("center-crop", "16x16", "out.zip"), ("center-crop-dhariwal", "8x8", "out_dir"),
    ("center-crop-wide", "16x12", "wide.zip"), (None, None, "copy")])
def test_dataset_tool_convert_matches_the_jax_tool(tmp_path, transform, res, dest):
    """Each image of the port's output equals the repository's
    ``dataset_tool.py``'s bit for bit (the same PIL resampling), and reads
    back through the port's dataset."""
    import dataset_tool as jtool
    from free_hunch_tpu.data.dataset import ImageFolderDataset as JDataset
    src = str(_image_dir(tmp_path))
    ours, theirs = str(tmp_path / ("t_" + dest)), str(tmp_path / ("j_" + dest))
    assert dataset_tool.convert(src, ours, res, transform) == jtool.convert(
        src, theirs, res, transform) == 3
    got, want = ImageFolderDataset(ours), JDataset(theirs)
    assert len(got) == len(want) == 3
    for i in range(3):
        np.testing.assert_array_equal(got[i][0], want[i][0])
    if res:
        w, h = (int(v) for v in res.split("x"))
        assert got[0][0].shape == (3, w if transform == "center-crop-wide" else h, w)


def test_frequency_analysis_matches_the_jax_tool(tmp_path):
    """The bundled images at 32 px: the DCT coefficients' mean and variance
    within 1e-5 of their scale of ``do_frequency_analysis.py``'s (f32 DCTs
    on both sides, f64 Welford); the zip case writes beside the archive."""
    from do_frequency_analysis import compute_dct_variance as jcompute
    mean, var = frequency_analysis.compute_dct_variance(str(BUNDLED), num_images=4,
                                                        resolution=32, batch_size=3,
                                                        device="cpu")
    jmean, jvar = jcompute(str(BUNDLED), num_images=4, resolution=32, batch_size=3)
    assert var.shape == (3, 32, 32) and var.dtype == np.float32 and (var >= 0).all()
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-5 * np.abs(jmean).max())
    np.testing.assert_allclose(var, jvar, rtol=0, atol=1e-5 * np.abs(jvar).max())
    zpath = tmp_path / "ds.zip"
    import zipfile
    with zipfile.ZipFile(zpath, "w") as zf:
        for name in sorted(os.listdir(BUNDLED))[:2]:
            zf.write(BUNDLED / name, name)
    out = frequency_analysis.main([f"--dataset_path={zpath}", "--num_images=2",
                                   "--resolution=16", "--device=cpu"])
    assert out == str(tmp_path / "ds")
    assert np.load(tmp_path / "ds" / "dct_variance.npz")["dct_variance"].shape == (3, 16, 16)
    assert tuple(torch.load(tmp_path / "ds" / "dct_variance.pt").shape) == (3, 16, 16)


def test_image_visualisation_matches_the_jax_tool(tmp_path):
    """Two run directories of the bundled images cut to 32 px (and one
    image of another size, which both resize): the grid equals
    ``create_image_visualisation.py``'s bit for bit."""
    from create_image_visualisation import build_grid as jbuild
    names = sorted(os.listdir(BUNDLED))[:3]
    for k, run in enumerate(("m1", "m2")):
        for sub in ("images", "cond_images", "forward_images"):
            d = tmp_path / run / sub
            d.mkdir(parents=True)
            for i, n in enumerate(names):
                img = png.read_png(str(BUNDLED / n))[k::8, i::8][:32, :32]
                if run == "m2" and sub == "images" and i == 2:
                    img = png.read_png(str(BUNDLED / n))[::4, ::4]
                png.write_png(str(d / n), np.ascontiguousarray(img))
    runs = [str(tmp_path / "m1"), str(tmp_path / "m2")]
    canvas, labels = image_visualisation.build_grid(runs, num_images=3)
    jcanvas, jlabels = jbuild(runs, num_images=3)
    assert labels == jlabels == ["ground truth", "measurement", "m1", "m2"]
    np.testing.assert_array_equal(canvas, jcanvas)
    image_visualisation.main(["--runs", *runs, "--num_images", "2", "--out",
                              str(tmp_path / "grid.png")])
    assert png.read_png(str(tmp_path / "grid.png")).shape == (4 + 4 * 36, 4 + 2 * 36, 3)


def test_convert_lpips_weights_matches_the_jax_script(tmp_path, monkeypatch):
    """Seeded stand-ins for the torchvision VGG16 and LPIPS head state
    dicts: the port's npz equals ``scripts/convert_lpips_weights.py``'s."""
    from free_hunch_tpu_torch.metrics import lpips
    rng = np.random.default_rng(0)
    vgg = {}
    for idx in lpips.VGG16_CONV_IDS:
        vgg[f"features.{idx}.weight"] = torch.as_tensor(rng.normal(size=(4, 3, 3, 3)))
        vgg[f"features.{idx}.bias"] = torch.as_tensor(rng.normal(size=(4,)))
    vgg["classifier.0.weight"] = torch.zeros(2, 2)
    lins = {f"lin{i}.model.1.weight": torch.as_tensor(rng.normal(size=(1, c, 1, 1)))
            for i, c in enumerate(lpips.TAP_CHANNELS)}
    torch.save(vgg, tmp_path / "vgg.pth")
    torch.save(lins, tmp_path / "lins.pth")
    convert_lpips_weights.main(["--vgg", str(tmp_path / "vgg.pth"), "--lins",
                                str(tmp_path / "lins.pth"), "--out", str(tmp_path / "t.npz")])
    monkeypatch.setattr(sys, "argv", ["convert_lpips_weights.py", "--vgg",
                                      str(tmp_path / "vgg.pth"), "--lins",
                                      str(tmp_path / "lins.pth"), "--out",
                                      str(tmp_path / "j.npz")])
    runpy.run_path(str(ROOT / "scripts" / "convert_lpips_weights.py"), run_name="__main__")
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(got.files) == sorted(want.files) == sorted(lpips.needed_keys())
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


def test_compute_fid_stats_equals_the_extractor_it_wraps(tmp_path):
    """Three bundled images at 32 px through the proxy InceptionV3: the
    saved moments equal those of the port's extractor called directly (the
    extractor itself is held to the JAX package in test_torch_metrics.py)."""
    from free_hunch_tpu_torch.metrics import fid
    out = str(tmp_path / "stats.npz")
    stats, is_proxy = compute_fid_stats.compute_fid_stats(
        str(BUNDLED), out, total_images=3, batch=2, resolution=32, device="cpu")
    assert is_proxy and stats.n == 3
    extract, _ = fid.make_extractor(device="cpu")
    ds = ImageFolderDataset(str(BUNDLED), resolution=32)
    want = fid.FeatureStats()
    want.add(extract(np.stack([ds[i][0] for i in range(3)]).astype(np.float32) / 127.5 - 1.0))
    saved = np.load(out)
    mu, sigma = want.mu_sigma()
    assert bool(saved["is_proxy"]) and int(saved["n"]) == 3
    np.testing.assert_allclose(saved["mu"], mu, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(saved["sigma"], sigma, rtol=1e-6, atol=1e-9)


SETUP_32 = ("--channel_mult 1,2 --attention_resolutions 16 --class_cond False "
            "--diffusion_steps 1000 --dropout 0.0 --image_size 32 --learn_sigma True "
            "--noise_schedule linear --num_channels 32 --num_head_channels 16 "
            "--num_res_blocks 1 --resblock_updown True --use_fp16 False "
            "--use_scale_shift_norm True --use_new_attention_order False")


def adm_forward_flops(batch, res=32, mc=32, mult=(1, 2), nrb=1, attn_ds=(2,), head_ch=16,
                      in_ch=3, out_ch=6):
    """The products of one ADM UNet forward (resblock up/down, scale-shift
    norm), two operations per multiply-add: (conv, linear, attention)."""
    ted = 4 * mc
    f = dict(conv=0, linear=0, attention=0)

    def conv(cin, cout, k, hw):
        f["conv"] += 2 * batch * cout * hw * hw * cin * k * k

    def lin(cin, cout, rows=1):
        f["linear"] += 2 * batch * rows * cin * cout

    def res_block(cin, cout, hw):
        conv(cin, cout, 3, hw)
        lin(ted, 2 * cout)
        conv(cout, cout, 3, hw)
        if cin != cout:
            conv(cin, cout, 1, hw)

    def attn(c, hw):
        t = hw * hw
        lin(c, 3 * c, t)
        f["attention"] += 2 * (2 * batch * t * t * c)   # q k^T and weights v
        lin(c, c, t)

    lin(mc, ted)
    lin(ted, ted)
    ch = mult[0] * mc
    conv(in_ch, ch, 3, res)
    chans, ds = [ch], 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            res_block(ch, m * mc, res // ds)
            ch = m * mc
            if ds in attn_ds:
                attn(ch, res // ds)
            chans.append(ch)
        if level != len(mult) - 1:
            ds *= 2
            res_block(ch, ch, res // ds)          # the downsampling ResBlock
            chans.append(ch)
    res_block(ch, ch, res // ds)
    attn(ch, res // ds)
    res_block(ch, ch, res // ds)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            res_block(ch + chans.pop(), m * mc, res // ds)
            ch = m * mc
            if ds in attn_ds:
                attn(ch, res // ds)
            if level and i == nrb:
                ds //= 2
                res_block(ch, ch, res // ds)      # the upsampling ResBlock
    conv(ch, out_ch, 3, res)
    return f


def test_count_flops_equals_the_closed_form_count(tmp_path):
    """The 32 px UNet's forward at batch 2: convolutions, linear layers
    and attention products each equal the closed form exactly. One guided
    call counts the forward (and its remat recomputes), the vjp (the
    input gradients of every convolution: the forward's count again, the
    weights being frozen) and the covariance algebra's matmuls."""
    setup = tmp_path / "setup32.txt"
    setup.write_text(SETUP_32)
    precond, model_args = count_flops.load_denoiser(str(setup), None, "cpu")
    rep = count_flops.report(precond, model_args, 2)
    want = adm_forward_flops(2)
    by = rep["by_operator"]
    assert by["aten.convolution"] == want["conv"]
    assert by["aten.addmm"] == want["linear"]
    assert by["aten.bmm"] == want["attention"]
    assert rep["flops_per_forward"] == sum(want.values())
    assert rep["params"] == sum(p.numel() for p in precond.parameters())
    full = count_flops.report(precond, model_args, 2, full_step=True)
    fb = full["by_operator"]
    assert fb["aten.convolution"] >= want["conv"]
    assert fb["aten.convolution_backward"] == want["conv"]
    assert full["flops_per_guided_call"] > 2 * rep["flops_per_forward"] and full["cg_niter"] > 0
