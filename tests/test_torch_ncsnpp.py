"""score_sde's NCSN++ in the port (``models/ncsnpp.py``, ``ops/fir.py``,
``models/precond.py::VEPrecond``, ``models/convert.py``,
``models/loading.py``) against the plain float32 reference of the
benchmark's ``ncsnpp`` family (``benchmark/reference/ncsnpp.py``, which
imports nothing of the port), on the CPU, at a small preset with every
block kind: 4 levels at 32 px, ``nf`` 8, attention at 8 px, both
pyramids, FIR resampling, the Fourier embedding. The weights are drawn as
the benchmark draws them (``benchmark/weights.py``).

Tolerances: the port in float32 computes what the reference computes, in
other orders of sums (cuDNN-free CPU convolutions, the plain GroupNorm's
two-level means), so a forward or pullback agrees to about 1e-7 of its
largest value; 1e-5 of it is the limit, a hundred times that and forty
times below a bf16 product's rounding (2^-8 = 3.9e-3 relative), which the
limit would catch."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from free_hunch_tpu_torch.models import convert, loading, ncsnpp
from free_hunch_tpu_torch.models.precond import VEPrecond
from free_hunch_tpu_torch.ops import fir
from free_hunch_tpu_torch.utils import profiling
from tests._torch_parity import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
DATA = os.path.join(ROOT, "data", "imagenet", "00000")
# relative to the largest value compared; see the module docstring
TOL = 1e-5
TINY = dict(image_size=32, num_channels=3, centered=False, nf=8, ch_mult=[1, 2, 2, 2],
            num_res_blocks=1, attn_resolutions=[8], fir_kernel=[1, 3, 3, 1],
            fourier_scale=16, sigma_min=0.01, sigma_max=1348, scale_by_sigma=True,
            skip_rescale=True, resblock_type="biggan", progressive="output_skip",
            progressive_input="input_skip", progressive_combine="sum",
            attention_type="ddpm", embedding_type="fourier", fir=True, conditional=True)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # a dataclass looks its module up while it is made
    spec.loader.exec_module(mod)
    return mod


REF = _module("ncsnpp_reference", os.path.join(BENCH, "reference", "ncsnpp.py"))
WEIGHTS = _module("benchmark_weights", os.path.join(BENCH, "weights.py"))
ARCH = REF.arch_of(TINY)
F32 = {"torso": "float32", "float32_params": []}


def _close(got, want, tol=TOL):
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def pair():
    """The port's f32 NCSN++ (remat off) with the benchmark's seeded
    weights, and the same weights for the reference."""
    w = WEIGHTS.make(REF.param_shapes(ARCH), 2 ** 31 + 99, "cpu", F32)
    model = ncsnpp.create_model(dtype=torch.float32, remat=False, **TINY)
    model.load_state_dict(w)
    return model.eval().requires_grad_(False), w


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((2, 3, 32, 32), generator=g)
    return x, torch.tensor([0.37, 21.0])


def test_the_parameters_are_the_references_in_order(pair):
    model, _ = pair
    sd = model.state_dict()
    shapes = REF.param_shapes(ARCH)
    assert [n for n, _, _ in shapes] == list(sd)
    assert all(tuple(sd[n].shape) == s for n, s, _ in shapes)
    assert sum(isinstance(m, ncsnpp.GroupNormpp) for m in model.modules()) == \
        len(REF.norm_inputs(ARCH))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_pullback_match_the_reference(pair, remat):
    model, w = pair
    if remat:
        model = ncsnpp.create_model(dtype=torch.float32, remat=True, **TINY)
        model.load_state_dict(w)
        model.eval().requires_grad_(False)
    x, s = _inputs()
    xr = x.clone().requires_grad_(True)
    want = REF.net(w, ARCH, xr, s)
    xp = x.clone().requires_grad_(True)
    got = model(xp, s)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    _close(torch.autograd.grad(got, xp, cot)[0], torch.autograd.grad(want, xr, cot)[0])


def test_a_bf16_product_breaks_the_tolerance(pair):
    """The limit catches one product in bf16 where float32 is stated: the
    reference with its torso's operands rounded to bf16."""
    _, w = pair
    x, s = _inputs()
    want = REF.net(w, ARCH, x, s)
    bf16 = REF.net(w, ARCH, x, s, rounding=lambda t: t.to(torch.bfloat16).float())
    err = float((bf16 - want).abs().max()) / float(want.abs().max())
    assert err > 10 * TOL


def test_the_bf16_torso_keeps_its_float32_parts(pair):
    _, w = pair
    model = ncsnpp.create_model(dtype=torch.bfloat16, remat=True, **TINY)
    model.load_state_dict(w)
    f32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert f32 == {n for n, _, k in REF.param_shapes(ARCH)
                   if n.startswith(("fourier.", "temb.")) or ".out_conv." in n
                   or k in ("norm_scale", "norm_shift")}
    x, s = _inputs()
    out = model(x, s)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # bf16 products: about 1e-2 of the output's scale, not the f32 1e-7
    err = float((out - REF.net(w, ARCH, x, s)).abs().max()) / float(out.abs().max())
    assert 10 * TOL < err < 0.1


@pytest.mark.parametrize("size", [(16, 16), (17, 9), (8, 5)], ids=["even", "odd", "mixed"])
@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
def test_fir_matches_upfirdn2d(size, up):
    g = torch.Generator().manual_seed(sum(size))
    x = torch.randn((2, 5) + size, generator=g)
    xr, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want = REF.upsample_2d(xr, (1, 3, 3, 1)) if up else REF.downsample_2d(xr, (1, 3, 3, 1))
    got = fir.fir_resample(xp, (1, 3, 3, 1), up=up)
    out = tuple(2 * n for n in size) if up else tuple(n // 2 for n in size)
    assert got.shape == want.shape == (2, 5) + out
    # 4 to 16 products a sample in float32 on both sides: a few ulps
    _close(got, want, 1e-6)
    cot = torch.randn(got.shape, generator=g)
    gx = torch.autograd.grad(got, xp, cot)[0]
    assert gx.shape == x.shape
    _close(gx, torch.autograd.grad(want, xr, cot)[0], 1e-6)


def test_fir_keeps_the_type_and_the_channels_last_layout():
    x = torch.randn(2, 16, 8, 8).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    for up in (False, True):
        y = fir.fir_resample(x, up=up)
        assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
        want = REF.upsample_2d(x.float(), (1, 3, 3, 1)) if up else \
            REF.downsample_2d(x.float(), (1, 3, 3, 1))
        # the kernel's taps are exact in bf16; one rounding of the output
        _close(y.float(), want, 2 ** -7)


@pytest.mark.parametrize("sigma", [0.01, 0.5, 7.0, 80.0])
def test_the_ve_preconditioner_is_the_references_preclamp(pair, sigma):
    model, w = pair
    pre = VEPrecond.around(model)
    assert (pre.sigma_min, pre.sigma_max) == REF.sigma_range(ARCH) == (0.01, 1348.0)
    assert REF.snap_grid(ARCH) is None
    assert np.array_equal(pre.round_sigma(np.array([0.3, 1.7])), [0.3, 1.7])
    x = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(1)) * 2 - 1
    D, var = pre(x, sigma)
    want = REF.preclamp(w, ARCH, x, sigma)
    _close(D, torch.clamp(want, -1.0, 1.0))
    # the map: the network sees (x + 1) / 2 at sigma / 2
    score = model((x + 1) / 2, torch.full((2,), sigma / 2))
    _close(D, torch.clamp(x + sigma ** 2 / 2 * score, -1.0, 1.0))
    assert torch.allclose(var, torch.full_like(var, sigma ** 2 / (1 + sigma ** 2)))


def _score_sde_state_dict(model):
    """The port's weights under score_sde's names, from the hand-listed
    module order of the tiny preset (``NCSNpp.__init__``'s appends): 0 the
    Fourier projection, 1-2 the dense layers, 3 the input conv; per level
    its block (attention at 8 px), then the down block and the Combine;
    the middle's block, attention, block; per level up its two blocks,
    attention at 8 px, the pyramid's GroupNorm and conv, the up block."""
    order = ["fourier", "temb.0", "temb.1", "conv_in",
             "down.0.res.0", "down.0.down", "down.0.combine",
             "down.1.res.0", "down.1.down", "down.1.combine",
             "down.2.res.0", "down.2.attn.0", "down.2.down", "down.2.combine",
             "down.3.res.0", "mid.0", "mid.1", "mid.2",
             "up.0.res.0", "up.0.res.1", "up.0.out_norm", "up.0.out_conv", "up.0.up",
             "up.1.res.0", "up.1.res.1", "up.1.attn", "up.1.out_norm", "up.1.out_conv",
             "up.1.up",
             "up.2.res.0", "up.2.res.1", "up.2.out_norm", "up.2.out_conv", "up.2.up",
             "up.3.res.0", "up.3.res.1", "up.3.out_norm", "up.3.out_conv"]
    rename = {"norm0": "GroupNorm_0", "conv0": "Conv_0", "dense": "Dense_0",
              "norm1": "GroupNorm_1", "conv1": "Conv_1", "skip": "Conv_2",
              "norm": "GroupNorm_0", "q": "NIN_0", "k": "NIN_1", "v": "NIN_2", "proj": "NIN_3"}
    out = {"sigmas": torch.ones(3)}
    for name, w in model.state_dict().items():
        mod = max((m for m in order if name.startswith(m + ".")), key=len)
        rest = name[len(mod) + 1:].split(".")
        src = f"all_modules.{order.index(mod)}"
        if mod == "fourier":
            out[f"{src}.W"] = w * 16
        elif mod.endswith(".combine"):
            out[f"{src}.Conv_0.{rest[0]}"] = w
        elif len(rest) == 1:
            out[f"{src}.{rest[0]}"] = w
        elif rest[0] in ("q", "k", "v", "proj"):
            out[f"{src}.{rename[rest[0]]}.{'W' if rest[1] == 'weight' else 'b'}"] = \
                w.t() if rest[1] == "weight" else w
        else:
            out[f"{src}.{rename[rest[0]]}.{rest[1]}"] = w
    return out


def test_convert_maps_score_sde_names(pair):
    model, _ = pair
    sd = _score_sde_state_dict(model)
    assert max(int(k.split(".")[1]) for k in sd if k != "sigmas") == 37
    assert [s for _, s, _ in convert.ncsnpp_name_map(model.cfg)] == \
        [k for k in sd if k != "sigmas"]
    want = model.state_dict()
    for wrapped in (sd, {f"module.{k}": v for k, v in sd.items()}, {"model": sd}):
        got = convert.ncsnpp_state_dict_from_score_sde(wrapped, model.cfg)
        assert list(got) == list(want)
        for k in want:
            assert torch.allclose(got[k], want[k], rtol=1e-6, atol=0), k


def test_load_model_builds_ncsnpp_from_a_setup_file_and_a_checkpoint(tmp_path, pair):
    model, _ = pair
    setup = tmp_path / "setup.json"
    setup.write_text(json.dumps(TINY))
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"model": _score_sde_state_dict(model)}, ckpt)
    m, args = loading.load_model(str(ckpt), str(setup), dtype=torch.float32, remat=False,
                                 device="cpu", architecture="ncsnpp")
    assert args["image_size"] == 32 and isinstance(m, ncsnpp.NCSNpp)
    for k, v in model.state_dict().items():
        assert torch.allclose(m.state_dict()[k], v, rtol=1e-6, atol=0), k
    pre = loading.wrap_precond(m, args, "ve")
    assert isinstance(pre, VEPrecond) and pre.img_resolution == 32
    with pytest.raises(ValueError, match="does not fit"):
        loading.wrap_precond(m, args, "linear")
    r1, _ = loading.load_model(str(tmp_path / "missing.pt"), str(setup), dtype=torch.float32,
                               device="cpu", architecture="ncsnpp", init_random_if_missing=True)
    r2, _ = loading.load_model(str(tmp_path / "missing.pt"), str(setup), dtype=torch.float32,
                               device="cpu", architecture="ncsnpp", init_random_if_missing=True)
    assert all(torch.equal(a, b) for a, b in zip(r1.parameters(), r2.parameters()))
    assert float(r1.fourier.W.std()) > 0.5 and float(r1.up[3].out_conv.weight.abs().max()) > 0
    with pytest.raises(ValueError, match="no quant"):
        loading.load_model(str(ckpt), str(setup), device="cpu", architecture="ncsnpp",
                           quant="int8")


def test_generate_conditional_runs_ncsnpp_with_the_ve_preconditioner(tmp_path):
    """One guided Free Hunch call (one Heun step: the last step takes no
    second call) of ``generate_conditional`` with NCSN++ from a setup file,
    seeded random weights, at 32 px."""
    from free_hunch_tpu_torch.generate_conditional import cmdline
    setup = tmp_path / "setup.json"
    setup.write_text(json.dumps(TINY))
    argv = [f"--outdir={tmp_path / 'out'}", f"--openai_setup_path={setup}",
            f"--openai_state_dict_path={tmp_path / 'missing.pt'}", "--allow_random_init=true",
            "--architecture=ncsnpp", "--iddpm_preconditioning=ve", f"--dataset_path={DATA}",
            "--total_images=2", "--batch_size=2", "--num_steps=1", "--dtype=float32",
            "--conditioning_mechanism=online_covariance", "--operator_name=gaussian_blur",
            "--image_base_covariance=dct_diagonal_noinfo", "--cov_capacity=4",
            "--mesh_shape=data:1", "--cg_maxiter=20"]
    res = cmdline(argv, device="cpu")
    assert res["images"] == 2 and np.isfinite(res["psnr"])
    with open(tmp_path / "out" / "config.json") as f:
        assert json.load(f)["architecture"] == "ncsnpp"


def _traced(fn):
    with profiling.trace(str(_traced.dir), device="cpu"):
        fn()
    return profiling.snapshot()


def test_fir_spans_and_counter_read_the_references_calls(pair, tmp_path):
    model, _ = pair
    _traced.dir = tmp_path
    n = len(REF.fir_inputs(ARCH))
    assert n == 18
    x, s = _inputs()
    with torch.no_grad():
        snap = _traced(lambda: model(x, s))
    assert snap["calls"]["fir.resample"] == snap["counts"]["fir_calls"] == n
    assert "fir.resample_backward" not in snap["calls"]
    assert snap["device_s"]["fir.resample"] > 0
    xp = x.clone().requires_grad_(True)
    snap = _traced(lambda: torch.autograd.grad(model(xp, s).sum(), xp))
    assert snap["calls"]["fir.resample"] == snap["counts"]["fir_calls"] == n
    assert snap["calls"]["fir.resample_backward"] == n
    # off: no range entered, nothing counted
    profiling.reset()
    with torch.no_grad():
        model(x, s)
    assert profiling.snapshot() == {"calls": {}, "counts": {}, "device_s": {}, "tallies": {}}


def test_fir_inputs_are_the_shapes_the_model_resamples(pair, monkeypatch):
    model, _ = pair
    seen = []
    real = ncsnpp.fir_resample

    def spy(x, taps=(1, 3, 3, 1), up=False):
        seen.append((x.shape[1], x.shape[2], x.shape[3], "up" if up else "down"))
        return real(x, taps, up)
    monkeypatch.setattr(ncsnpp, "fir_resample", spy)
    x, s = _inputs()
    with torch.no_grad():
        model(x, s)
    assert seen == REF.fir_inputs(ARCH)
