"""The 32 px int8 witness of chip_smoke.py (its phase 3), run here with the
CPU on both sides: what a sound path reads against its limits, and that
each wrong int8 path breaks them. On the card one side runs K1-K3 and the
other the plain versions; here the "card" side is the CPU again, either
with a 1e-6 (slice) or 1e-7 (module replay) relative change of its input,
which moves int8 codes at rounding ties as the card's other summation
orders do, or with one piece of the int8 path made wrong.

The readings these tests print are the ones PERF.md (section 6, PR 2)
quotes beside the limits."""
import contextlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from free_hunch_tpu_torch.ops import gn_quant as gq
from free_hunch_tpu_torch.ops import quant as q
from tests._torch_parity import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return cs.Int8Reference(0, str(tmp_path_factory.mktemp("prior")))


_CLEAN = {}


def _clean(ref, quant, fused):
    if quant not in _CLEAN:
        side = ref.run(quant, fused, "cpu")
        recs = cs.int8_module_inputs(side["model"], *ref.unet_input("cpu"))
        _CLEAN[quant] = side, recs, cs.int8_module_replay(side["model"], recs)
    return _CLEAN[quant]


def _module_readings(cpu, card, ref, ctx=contextlib.nullcontext):
    """The phase's module check, the "card" side under ``ctx``."""
    for name, mod in cpu["model"].named_modules():
        if isinstance(mod, q._QuantSite):
            card["model"].get_submodule(name).act_scale.copy_(mod.act_scale)
    with ctx():
        recs = cs.int8_module_inputs(card["model"], *ref.unet_input("cpu"))
        got = cs.int8_module_replay(card["model"], recs)
    return cs.int8_module_readings(recs, cs.int8_module_replay(cpu["model"], recs), got)


@pytest.mark.parametrize("quant,fused", [("int8", True), ("int8_static", False)],
                         ids=["fused", "static"])
def test_sound_paths_read_inside_the_limits(ref, quant, fused):
    """Slice: noise changed by 1e-6 relative (observed: raw UNet 1.3e-2
    and 1.5e-2, steps up to 9.1e-3, 1.6e-2, 7.2e-2, tables 1.9e-2, CG niter
    equal). Modules: each recorded input changed by 1e-7 relative
    (observed: output 3.2e-4, input gradient 1.1e-7)."""
    cpu, recs, base = _clean(ref, quant, fused)
    rng = np.random.default_rng(5)
    nz = (ref.noise * (1 + 1e-6 * rng.normal(size=ref.noise.shape))).astype(np.float32)
    r = ref.readings(cpu, ref.run(quant, fused, "cpu", noise=nz))
    nrecs = [(n, x * (1 + 1e-7 * torch.as_tensor(rng.normal(size=x.shape), dtype=x.dtype)),
              g) for n, x, g in recs]
    m = cs.int8_module_readings(recs, base, cs.int8_module_replay(cpu["model"], nrecs))
    print(quant, r, m)
    assert r["unet_rel_rms"] > 0 and m["out_rel_rms"][0] > 0   # codes did flip
    assert cs.int8_reference_failures(r, m) == []


def _no_fold(g, qw, pad, out_dtype):
    gq_, gs = q._quantize_act(g)
    return q.int8_conv_nhwc(gq_, qw.wkT, gs.reshape(-1), qw.ones_in,
                            qw.wk.shape[1] - 1 - pad, out_dtype)


def _act(x, batch_wide=False, rounding=torch.round):
    dims = tuple(range(0 if batch_wide else 1, x.dim()))
    amax = x.abs().float().amax(dim=dims, keepdim=True)
    scale = (torch.clamp(amax, min=1e-12) * (1.0 / 127.0)).expand(
        x.shape[0], *[1] * (x.dim() - 1)).contiguous()
    return torch.clamp(rounding(x * (1.0 / scale).to(x.dtype)), -127, 127).to(torch.int8), scale


_real_gq = gq.gn_silu_quant

WRONG = {
    "pullback_without_weight_scale_fold": (q, "_int8_pullback", _no_fold),
    "activation_codes_by_floor": (q, "_quantize_act",
                                  lambda x: _act(x, rounding=torch.floor)),
    "one_activation_scale_per_batch": (q, "_quantize_act", lambda x: _act(x, True)),
    "fused_norm_without_beta": (q, "gn_silu_quant",
                                lambda x, g, b, groups=32, eps=1e-5:
                                _real_gq(x, g, b * 0, groups, eps)),
}


@pytest.mark.parametrize("quant,fused,wrong", [
    ("int8", True, "pullback_without_weight_scale_fold"),
    ("int8", True, "activation_codes_by_floor"),
    ("int8", True, "one_activation_scale_per_batch"),
    ("int8", True, "fused_norm_without_beta"),
    ("int8_static", False, "pullback_without_weight_scale_fold"),
    ("int8_static", False, "activation_codes_by_floor"),
    ("int8_static", False, "one_activation_scale_per_batch")])
def test_wrong_paths_break_the_limits(ref, monkeypatch, quant, fused, wrong):
    """Each wrong path on the "card" side fails the phase. Observed: the
    lost fold reads 0.43, 1.0, 1.4 on the Heun steps, differing CG niter
    and 9.5e3 on a module's input gradient; the others read 1.4e-2 to
    0.24 on a module (2e-3 limit) but stay inside the slice's limits,
    where one flipped code moves as much."""
    cpu, _, _ = _clean(ref, quant, fused)
    obj, name, fn = WRONG[wrong]

    @contextlib.contextmanager
    def wrong_path():
        with monkeypatch.context() as mp:
            mp.setattr(obj, name, fn)
            yield

    with wrong_path():
        card = ref.run(quant, fused, "cpu")
    r = ref.readings(cpu, card)
    m = _module_readings(cpu, card, ref, wrong_path)
    bad = cs.int8_reference_failures(r, m)
    print(quant, wrong, r, m, bad)
    assert any(b.startswith("module") for b in bad), bad
    if wrong == "pullback_without_weight_scale_fold":
        assert "CG niter differs" in bad and any(b.startswith("Heun") for b in bad)




def test_the_parity_tests_weights_flip_as_much_as_the_seeded_ones(ref):
    """Why the witness keeps ``random_init_``'s seeded weights (made without
    JAX) rather than the parity tests' flax-initialised ``tiny_pair``: on
    both, the largest move of the fused int8 UNet's output over three 1e-6
    relative changes of its input exceeds 1 % of its max at every timestep,
    where the f32 torso moves by less than 1e-5 of it."""
    from free_hunch_tpu_torch.models.unet import create_model
    from tests._torch_parity import tiny_pair

    rng = np.random.default_rng(1)
    noise = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    nudged = [(noise * (1 + 1e-6 * rng.normal(size=noise.shape))).astype(np.float32)
              for _ in range(3)]
    for label, state in (("seeded", ref.state), ("tiny_pair", tiny_pair()[2].state_dict())):
        for quant, fused in (("int8", True), (None, False)):
            model = create_model(**cs.TINY, dtype=torch.float32, quant=quant,
                                 fused_gn_quant=fused)
            model.load_state_dict(state)
            model.eval().requires_grad_(False)
            for t, c in ((999.0, 1 / 80), (500.0, 0.3), (10.0, 1.0)):
                tt = torch.full((2,), t)
                f = model(torch.as_tensor(noise * c), tt)
                d = max(float((model(torch.as_tensor(n * c), tt) - f).abs().max()
                              / f.abs().max()) for n in nudged)
                print(label, quant, t, d)
                assert (d > 1e-2) if quant else (d < 1e-5), (label, quant, t, d)
