"""chip_smoke.py's phase 9 (the paper's commands through the driver),
rehearsed with the CPU on both sides.

The witness's four 32 px cases (``PAPER_REF_CASES``: Free Hunch on the
motion blur, the identity prior, the covariance and the hybrid gradient):
the "card" side is the CPU again with every denoiser output multiplied by
(1 + 1e-7 N(0, 1)), a stand-in for another device's rounding (the card
read 0.08-0.21 of the sample limit, PERF.md section 6; a 1e-7 nudge reads
0.11-0.18 here). A sound path reads inside the limits; a wrong path of
each case (another operator, prior or gradient) breaks them. The DCT
prior truncated to 32 px, which the motion case leaves out, breaks them
already at a 1e-8 nudge. The full-width runs are rehearsed at 32 px: the
hooks' GroupNorm calls equal the count each mode fixes
(``paper_expected``), and the launch check fails, as it must without
kernels. ``--paper`` runs phase 9 alone."""
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from free_hunch_tpu_torch.models.unet import create_model
from tests._torch_parity import one_thread  # noqa: F401

NUDGE = 1e-7
_CPU = {}
SETUP32 = ("--channel_mult 1,2 --attention_resolutions 8 --class_cond False "
           "--diffusion_steps 1000 --dropout 0.0 --image_size 32 --learn_sigma True "
           "--noise_schedule linear --num_channels 32 --num_head_channels 16 "
           "--num_res_blocks 1 --resblock_updown True --use_fp16 False "
           "--use_scale_shift_norm True --use_new_attention_order False")
# the FFHQ setup's topology at 32 px: six levels, one res block, attention at ds 16
FFHQ32 = ("--attention_resolutions 2 --class_cond False --diffusion_steps 1000 "
          "--dropout 0.0 --image_size 32 --channel_mult 1,1,2,2,4,4 --learn_sigma True "
          "--noise_schedule linear --num_channels 32 --num_head_channels 64 "
          "--num_res_blocks 1 --resblock_updown True --use_fp16 False "
          "--use_scale_shift_norm True --use_new_attention_order False")


@pytest.fixture(scope="module")
def dref(tmp_path_factory):
    return cs.DriverReference(0, tmp_path_factory.mktemp("paper"))


def _case(name, **over):
    return dict(cs.PAPER_REF_CASES[name], num_steps=cs.PAPER_REF_STEPS, **over)


def _cpu(dref, name):
    if name not in _CPU:
        _CPU[name] = dref.run("cpu", f"cpu_{name}", case=_case(name))
    return _CPU[name]


@pytest.mark.parametrize("name", list(cs.PAPER_REF_CASES))
def test_sound_path_reads_inside_the_limits(dref, name):
    cpu = _cpu(dref, name)
    card = dref.run("cpu", f"sound_{name}", nudge=NUDGE, case=_case(name))
    ratio, bad = cs.driver_reference_failures(cpu, card, cs.PAPER_SAMPLE_ABS)
    print("paper sound", name, {k: round(v, 4) for k, v in ratio.items() if "samples" in k})
    assert bad == [] and max(ratio.values()) < 0.5
    # 9 guided calls a batch at 5 Heun steps, counted and compared
    assert [len(n) for n in cpu["niter"]] == [9, 9] == [len(r) for r in cpu["resets"]]
    assert cpu["resets"] == card["resets"] and all(r[-1] == 0 for r in cpu["resets"])
    assert cpu["launches"] == card["launches"] == 0


WRONG = {"motion_blur": dict(operator_name="gaussian_blur"),
         "identity": dict(image_base_covariance="dct_diagonal"),
         "covariance": dict(guidance_gradient="vjp"),
         "hybrid": dict(guidance_vjp_below=0.0)}


@pytest.mark.parametrize("name", list(WRONG))
def test_wrong_paths_break_the_limits(dref, name):
    cpu = _cpu(dref, name)
    card = dref.run("cpu", f"wrong_{name}", nudge=NUDGE, case=_case(name, **WRONG[name]))
    ratio, bad = cs.driver_reference_failures(cpu, card, cs.PAPER_SAMPLE_ABS)
    print("paper wrong", name, {k: round(v, 3) for k, v in ratio.items() if "samples" in k})
    assert any("samples" in b for b in bad), bad


def test_the_truncated_dct_prior_is_chaotic_at_32px(dref):
    """Why the motion case keeps 5a's flat prior: with the 256 px DCT prior
    truncated to 32 px (``FreeHunch._init_diag``, as the JAX package does),
    a 1e-8 nudge of the denoiser already moves the final samples past the
    limit, with the CG counts unchanged."""
    case = _case("motion_blur", image_base_covariance="dct_diagonal")
    cpu = dref.run("cpu", "dct_cpu", case=case)
    card = dref.run("cpu", "dct_nudged", nudge=1e-8, case=case)
    ratio, bad = cs.driver_reference_failures(cpu, card, cs.PAPER_SAMPLE_ABS)
    print("truncated DCT prior", {k: round(v, 3) for k, v in ratio.items() if "samples" in k})
    assert cpu["niter"] == card["niter"]
    assert any("samples" in b for b in bad), bad


def _tiny(remat: bool):
    return create_model(image_size=32, num_channels=32, num_res_blocks=1, channel_mult="1,2",
                        attention_resolutions="8", num_head_channels=16,
                        dtype=torch.float32, remat=remat)


def test_expected_counts_follow_the_mode():
    model = _tiny(remat=True)
    xs = dict(use_heun=np.asarray([True, True, False]),
              sigma_hat=np.asarray([80.0, 2.5, 0.002], np.float32),
              sigma_prime=np.asarray([2.5, 0.002, 0.0], np.float32))
    assert cs.guided_sigmas(xs) == pytest.approx([80.0, 2.5, 2.5, 0.002, 0.002])
    fh = dict(conditioning_mechanism="online_covariance")
    got = {mode: cs.paper_expected(model, dict(fh, guidance_gradient=mode,
                                               guidance_vjp_below=2.0), xs)
           for mode in ("vjp", "covariance", "hybrid")}
    got["dps"] = cs.paper_expected(model, dict(conditioning_mechanism="dps"), xs)
    got["ddnm"] = cs.paper_expected(model, dict(conditioning_mechanism="ddnm", num_steps=6),
                                    None)
    norms, rec = got["vjp"]["norms"], got["vjp"]["recomputes"]
    assert (norms, rec) == (22, 20)
    assert {k: v["k1"] for k, v in got.items()} == dict(
        vjp=5 * (norms + rec), covariance=5 * norms, hybrid=5 * norms + 2 * rec,
        dps=5 * (norms + rec), ddnm=6 * norms)
    # without remat a pullback recomputes nothing
    assert cs.paper_expected(_tiny(remat=False), dict(fh, guidance_gradient="vjp"),
                             xs)["k1"] == 5 * norms


@pytest.fixture
def rehearsal(tmp_path, monkeypatch):
    """Phase 9's runs on the CPU at 32 px: the CUDA-only calls made no-ops,
    the 256 px setups swapped for 32 px ones."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    (tmp_path / "setup32.txt").write_text(SETUP32)
    (tmp_path / "ffhq32.txt").write_text(FFHQ32)
    monkeypatch.setattr(cs, "SETUP_256", tmp_path / "setup32.txt")
    monkeypatch.setattr(cs, "SETUP_FFHQ", tmp_path / "ffhq32.txt")
    work = tmp_path / "runs"
    work.mkdir()
    return work


# the hooks' GroupNorm calls of each run at 32 px, 3 Heun steps (5 guided
# calls): 22 norms a forward and 20 recomputed in a pullback on the tiny
# UNet, 65 and 60 on the FFHQ topology
REHEARSED = {"freehunch_motion": 210, "sweep_inpainting_identity": 210,
             "freehunch_blur_covariance": 110, "freehunch_blur_hybrid": 150,
             "pigdm_blur": 210, "ddnm_sr": 132, "9f": 625}


@pytest.mark.parametrize("label,name,extra", [r for r in cs.PAPER_RUNS
                                               if r[1] in REHEARSED or r[0] == "9f"],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_runs_rehearsed_on_the_cpu(rehearsal, label, name, extra):
    want = REHEARSED["9f" if label == "9f" else name]
    with pytest.raises(AssertionError) as err:
        cs.paper_run(label, name, extra, 0, rehearsal, "cpu rehearsal", dev="cpu")
    # the artifacts and the mode's count hold; only the launch check fails
    assert str(err.value) == f"{label} {name}: " + repr(
        [f"K1 launches 0, hooks {want}, the mode's {want}"])


def test_the_runs_cover_the_paper_commands():
    from free_hunch_tpu_torch.tools import paper_configs as pc
    labels = [r[0] for r in cs.PAPER_RUNS]
    assert labels == ["9a", "9b", "9b", "9b", "9c", "9c", "9d", "9d", "9d", "9e", "9f"]
    assert all(r[1] in pc.COMMANDS for r in cs.PAPER_RUNS)
    # the sweep's dct_diagonal half runs in earlier phases; every other
    # entry of the table runs here
    assert {r[1] for r in cs.PAPER_RUNS if not r[2]} == set(pc.COMMANDS) - {
        f"sweep_{o}_dct_diagonal" for o in pc.SWEEP_OPERATORS}


def test_paper_flag_runs_phase_9_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs, "card_facts", lambda: "card")
    monkeypatch.setattr(cs, "paper_phase", lambda seed, smi: calls.append((seed, smi)))

    def refuse(*a, **k):
        raise AssertionError("another phase ran")
    for name in ("oracle_phase", "driver_phase", "model_axis_phase", "gn_phase",
                 "slice_phase", "vae_phase"):
        monkeypatch.setattr(cs, name, refuse)
    monkeypatch.setattr(cs.loading, "load_model", refuse)
    assert cs.main(["--paper", "--seed", "3"]) == 0
    assert calls == [(3, "card")]
