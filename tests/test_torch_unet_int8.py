"""Port parity for the int8 torso: the 32 px UNet of tests/_torch_parity.py
in each of ``int8``, ``int8`` with the fused GroupNorm route, ``int8_static``
and ``int8_calib`` against ``free_hunch_tpu.models.unet`` with the same
weights; the preconditioner's stage selection; the calibration against the
JAX package's; the qscales converter and cache key.

Tolerance of the UNet outputs: both packages quantise with the same f32
arithmetic, but a GroupNorm, attention or f32 conv in two frameworks moves
an activation by ~1e-7 relative, which flips an int8 code where the scaled
value lies that close to a half-integer; each flip moves its product by one
quantisation step (1/127 of the site's range), and a few propagate. The f32
outputs are held to 2e-3 of their max |value|; bf16 rounds each activation
to 8 bits (2^-8 relative) and is held to 3e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu_torch.models import calibrate as tcal
from free_hunch_tpu_torch.models import loading as tload
from free_hunch_tpu_torch.models.convert import (qscales_from_flax, qscales_to_flax,
                                                 quant_site_paths)
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
from free_hunch_tpu_torch.models.precond import _select_qscales
from free_hunch_tpu_torch.ops.quant import QuantConv, QuantDense, _QuantSite

from tests._torch_parity import RES, quant_pair
from tests.test_torch_freehunch import _mechs, prior_dir  # noqa: F401

F32 = np.float32
TINY_ARGS = dict(image_size=RES, num_channels=32, num_res_blocks=1, channel_mult="1,2",
                 attention_resolutions="8", num_head_channels=16, learn_sigma=True)


def _inputs(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3, RES, RES)).astype(F32)


def _jax_apply(jm, params, x, t, fused, monkeypatch, **kw):
    """Trace and run the JAX model; ``fused`` sets the JAX package's switch
    while it traces."""
    if fused:
        monkeypatch.setenv("FREE_HUNCH_FUSED_GN_QUANT", "1")
    out = jax.jit(lambda p, a, b: jm.apply(p, a, b, **kw))(params, jnp.asarray(x),
                                                           jnp.asarray(t))
    monkeypatch.delenv("FREE_HUNCH_FUSED_GN_QUANT", raising=False)
    return out


def _amax_table(qstats, cfg):
    """The JAX 'qstats' tree -> {site: amax}, through the converter's site
    pairs."""
    out = {}
    for site, path in quant_site_paths(cfg).items():
        node = qstats
        for k in path:
            node = node.get(k) if hasattr(node, "get") else None
        if node is not None:
            a = node["amax"]
            out[site] = float(np.asarray(a[0] if isinstance(a, tuple) else a))
    return out


@pytest.mark.parametrize("quant,fused,dtype,tol,quant_1x1", [
    ("int8", False, "f32", 2e-3, True), ("int8", True, "f32", 2e-3, True),
    ("int8_calib", False, "f32", 2e-3, True), ("int8", True, "bf16", 3e-2, True),
    ("int8", True, "f32", 5e-3, False)],
    ids=["int8", "int8_fused", "int8_calib", "int8_fused_bf16", "int8_fused_plain_1x1"])
def test_int8_unet_forward_matches_jax(quant, fused, dtype, tol, quant_1x1, monkeypatch):
    """``quant_1x1=False`` keeps the 1x1 skips as plain convs, as the JAX
    package's FREE_HUNCH_QUANT_1X1=0 does (set while it traces). Their f32
    sums round differently in the two frameworks, where the int8 sums are
    exact in both, so more codes flip downstream (module docstring): held
    to 5e-3 of the max (observed 2.1e-3 on 4 of 12288 elements; the port
    with its skips quantised reads 1.7e-2 against this JAX model)."""
    jm, params, tm = quant_pair(quant, fused=fused, dtype=dtype, quant_1x1=quant_1x1)
    x = _inputs()
    t = np.asarray([10.0, 700.0], F32)
    if not quant_1x1:
        monkeypatch.setenv("FREE_HUNCH_QUANT_1X1", "0")
    if quant == "int8_calib":
        want, mut = _jax_apply(jm, params, x, t, fused, monkeypatch, mutable=["qstats"])
    else:
        want = _jax_apply(jm, params, x, t, fused, monkeypatch)
    got = tm(torch.as_tensor(x), torch.as_tensor(t))
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 6, RES, RES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    n_sites = sum(isinstance(m, _QuantSite) for m in tm.modules())
    skips = [m.skip_connection for m in tm.modules() if getattr(m, "skip_connection", None)]
    assert skips and all(isinstance(m, QuantConv) == quant_1x1 for m in skips)
    # all but the first and last conv, and the 1x1 skips unless quantised
    assert n_sites == len(quant_site_paths(tm.cfg)) - 2 - (0 if quant_1x1 else len(skips))
    if quant == "int8_calib":
        jamax = _amax_table(mut["qstats"], tm.cfg)
        tamax = {n: float(m.amax) for n, m in tm.named_modules() if isinstance(m, _QuantSite)}
        assert sorted(jamax) == sorted(tamax)
        for k in jamax:   # each site's abs-max over the same activation
            assert abs(tamax[k] - jamax[k]) <= 1e-3 * jamax[k], (k, tamax[k], jamax[k])


SIGMAS = np.asarray([0.5, 5.0, 50.0], F32)


def _unet_args(pre, x, sigma):
    """The UNet's inputs inside the preconditioner: (c_in x, c_noise)."""
    c_in = 1.0 / np.sqrt(np.float32(sigma) ** 2 + 1.0)
    c_noise = pre.M - pre.round_sigma(np.full((x.shape[0],), sigma, F32), return_index=True)
    return (c_in * x).astype(F32), c_noise.astype(F32)


def _table(cfg, pre):
    """A 3-stage table as the calibration builds it: at each stage sigma
    the JAX calib model's per-site abs-max on that stage's input, margin
    1.1."""
    jc, pc, _ = quant_pair("int8_calib")
    run = jax.jit(lambda p, a, b: jc.apply(p, a, b, mutable=["qstats"]))
    stages = []
    for sigma in SIGMAS:
        _, mut = run(pc, *map(jnp.asarray, _unet_args(pre, _inputs(5) * sigma, sigma)))
        stages.append(_amax_table(mut["qstats"], cfg))
    return SIGMAS, {k: np.asarray([st[k] for st in stages], F32) * np.float32(1.1 / 127)
                    for k in stages[0]}


def test_int8_static_unet_matches_jax_with_the_same_table():
    """The same table reaches both packages through the converter. A
    static scale is batch-wide, so its int8 step is coarser than a
    per-sample one for the smaller sample, and a flipped code (module
    docstring) moves that sample's output further: the raw UNet is held to
    5e-3 of its max (observed 3.1e-3), and the preconditioned
    D = clip(x - sigma F), whose F differences are multiplied by sigma, to
    5e-3 * max(1, sigma) (the dynamic torso's D differs by 2.8e-3 at sigma
    0.7 on the same input)."""
    jm, params, tm = quant_pair("int8_static")
    tp0 = TPrecond(torch.nn.Identity(), img_resolution=RES, img_channels=3)
    qs = _table(tm.cfg, tp0)
    jsig, jtree = qscales_to_flax(qs, tm.cfg)
    back = qscales_from_flax((jsig, jtree), tm.cfg)
    assert sorted(back[1]) == sorted(qs[1])
    for k in qs[1]:
        np.testing.assert_array_equal(back[1][k], qs[1][k])
    jp = JPrecond(jm, img_resolution=RES, img_channels=3,
                  qscales=(jsig, jax.tree.map(jnp.asarray, jtree)))
    tp = tload.wrap_precond(tm, {"image_size": RES}, qscales=back)
    for sigma in (0.7, 5.0):
        x = _inputs(5) * sigma
        s = float(F32(sigma))
        jd, jv = jax.jit(jp.apply)(params, jnp.asarray(x), jnp.asarray(s, jnp.float32))
        td, tv = tp(torch.as_tensor(x), s)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=5e-3 * max(1.0, sigma))
    # the raw UNet at the stage the last call selected (sigma 5)
    stage = {**params, "qscales": jax.tree.map(lambda a: jnp.asarray(a)[1], jtree)}
    x, t = _unet_args(tp0, _inputs(5) * 5.0, 5.0)
    want = np.asarray(jax.jit(jm.apply)(stage, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 * np.abs(want).max())


def test_int8_fused_denoiser_vjp_matches_jax(monkeypatch):
    """The guidance pullback through the fused int8 torso (K2 -> K3 in the
    forward, the int8 transposed products and f32 GroupNorm autograd in the
    backward), remat on in the port: held to 1e-2 of its scale (the
    cotangent is quantised per sample at every site, and a flipped code
    there moves its product by one step of the cotangent's range)."""
    jm, params, _ = quant_pair("int8", fused=True)
    _, _, tm = quant_pair("int8", fused=True, remat=True)
    jp = JPrecond(jm, img_resolution=RES, img_channels=3)
    sigma = float(F32(1.7))
    x = _inputs(2) * 2.0
    ct = np.random.default_rng(3).normal(size=x.shape).astype(F32)
    monkeypatch.setenv("FREE_HUNCH_FUSED_GN_QUANT", "1")

    @jax.jit
    def jvjp(v, c):
        _, pull = jax.vjp(lambda u: jp.apply(params, u, jnp.float32(sigma))[0], v)
        return pull(c)[0]

    want = np.asarray(jvjp(jnp.asarray(x), jnp.asarray(ct)))
    tp = TPrecond(tm, img_resolution=RES, img_channels=3)
    xt = torch.as_tensor(x).requires_grad_(True)
    d, _ = tp(xt, sigma)
    (got,) = torch.autograd.grad(d, xt, grad_outputs=torch.as_tensor(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2 * np.abs(want).max())


def test_precond_selects_stage_scales_by_nearest_sigma():
    """Mirror of tests/test_quant.py:318-328: the stage whose calibration
    sigma is nearest, from a host float or a tensor sigma."""
    sigmas = np.asarray([0.1, 1.0, 10.0], F32)
    for sig, want in ((0.12, 0), (2.0, 1), (80.0, 2)):
        assert int(_select_qscales(torch.as_tensor(sigmas), sig)) == want
        assert int(_select_qscales(torch.as_tensor(sigmas), torch.full((2,), sig))) == want
    model = tload.create_model(dtype=torch.float32, quant="int8_static", remat=False,
                               **TINY_ARGS)
    sites = [n for n, m in model.named_modules() if isinstance(m, _QuantSite)]
    table = {n: np.asarray([1.0, 2.0, 3.0], F32) * (i + 1) for i, n in enumerate(sites)}
    pre = tload.wrap_precond(model, TINY_ARGS, qscales=(sigmas, table))
    for sig, stage in ((0.12, 0), (2.0, 1), (80.0, 2)):
        for s in (sig, torch.full((2,), sig)):
            pre(torch.zeros(2, 3, RES, RES), s)
            for i, n in enumerate(sites):
                m = model.get_submodule(n)
                assert float(m.act_scale) == (stage + 1.0) * (i + 1), (n, sig)
    with pytest.raises(KeyError, match="lacks"):
        tload.wrap_precond(model, TINY_ARGS, qscales=(sigmas, {sites[0]: table[sites[0]]}))


def test_wrap_precond_requires_qscales_for_static(tmp_path):
    setup = tmp_path / "setup.txt"
    setup.write_text(" ".join(f"--{k} {v}" for k, v in TINY_ARGS.items()))
    m, args = tload.load_model(str(tmp_path / "missing.pt"), str(setup), device="cpu",
                               dtype=torch.bfloat16, init_random_if_missing=True,
                               quant="int8_static")
    with pytest.raises(ValueError, match="calibration table"):
        tload.wrap_precond(m, args)
    # quantised sites keep f32 master weights on the bf16 torso
    assert all(p.dtype == torch.float32 for q in m.modules()
               if isinstance(q, (QuantConv, QuantDense)) for p in q.parameters())
    assert m.input_blocks[0][0].weight.dtype == torch.bfloat16


def test_calibrate_qscales_matches_jax(prior_dir):
    """3 Heun steps (5 denoiser calls at 3 distinct sigmas) through both
    packages' calibration, with the covariance-gradient Free Hunch of
    tests/test_torch_freehunch.py: the same sigma grid, and each site's
    scale at each stage within 3e-2 relative, their median within 3e-3. A
    site's abs-max is one element, which moves by a whole int8 step of an
    upstream product wherever a code flips between the packages (module
    docstring): at the first stage, whose input is the same noise on both
    sides, up to 1.3e-2 at a decoder site; the later stages add the two
    trajectories' difference (observed: max 1.33e-2, median 8.2e-4)."""
    from free_hunch_tpu.models.calibrate import calibrate_qscales as jcalibrate
    from free_hunch_tpu.samplers import edm as jedm
    _, params, tm = quant_pair("int8")
    pre = JPrecond(None, img_resolution=RES, img_channels=3)
    xs, s0 = jedm.prepare_schedule(
        round_sigma=pre.round_sigma, net_sigma_min=pre.sigma_min,
        net_sigma_max=pre.sigma_max, num_steps=3, solver="heun", discretization="edm",
        schedule="linear", scaling="none")
    jmech, tmech = _mechs(prior_dir, cov_capacity=jedm.required_cov_capacity(xs),
                          guidance_gradient="covariance")
    rng = np.random.default_rng(7)
    noise = rng.normal(size=(2, 3, RES, RES)).astype(F32)
    y = rng.uniform(-1, 1, (2, 3, RES, RES)).astype(F32)
    jsig, jtree = jcalibrate(TINY_ARGS, params, jmech, jnp.asarray(noise), jnp.asarray(y),
                             xs, s0, jax.random.PRNGKey(0), dtype=jnp.float32)
    tsig, ttable = tcal.calibrate_qscales(TINY_ARGS, tm.state_dict(), tmech,
                                          torch.as_tensor(noise), torch.as_tensor(y), xs, s0,
                                          dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tsig, np.asarray(jsig))
    assert len(tcal.calibration_stages(xs)) == 5
    assert tsig.shape == (3,) and np.all(np.diff(tsig) > 0)
    _, want = qscales_from_flax((jsig, jtree), tm.cfg)
    assert sorted(want) == sorted(ttable)
    rel = np.stack([np.abs(ttable[k] - want[k]) / want[k] for k in sorted(want)])
    assert rel.max() <= 3e-2 and np.median(rel) <= 3e-3, (rel.max(), np.median(rel))


def test_qscales_cache_key_follows_the_sigma_grid(tmp_path):
    """A different schedule (sigma grid) or operator misses the cache; the
    table round-trips through save/load; merge takes the site-wise max."""
    from free_hunch_tpu_torch.samplers import edm as tedm
    pre = TPrecond(torch.nn.Identity(), img_resolution=RES, img_channels=3)

    def grid(steps):
        return tedm.prepare_schedule(round_sigma=pre.round_sigma, net_sigma_min=pre.sigma_min,
                                     net_sigma_max=pre.sigma_max, num_steps=steps)[0]

    ck = str(tmp_path / "ck.pt")
    k1 = tcal.qscales_cache_key(ck, TINY_ARGS, grid(3), RES, 1.1, "blur")
    assert k1 == tcal.qscales_cache_key(ck, TINY_ARGS, grid(3), RES, 1.1, "blur")
    assert k1 != tcal.qscales_cache_key(ck, TINY_ARGS, grid(4), RES, 1.1, "blur")
    assert k1 != tcal.qscales_cache_key(ck, TINY_ARGS, grid(3), RES, 1.1, "inpaint")
    xs = grid(3)
    xs_moved = {**xs, "sigma_hat": xs["sigma_hat"] * np.float32(1.01)}
    assert k1 != tcal.qscales_cache_key(ck, TINY_ARGS, xs_moved, RES, 1.1, "blur")
    sig = np.asarray([0.5, 5.0], F32)
    a = (sig, {"s": np.asarray([1.0, 4.0], F32), "t": np.asarray([2.0, 2.0], F32)})
    b = (sig, {"s": np.asarray([3.0, 1.0], F32), "t": np.asarray([1.0, 5.0], F32)})
    tcal.save_qscales(k1, *a)
    got = tcal.load_qscales(k1)
    np.testing.assert_array_equal(got[0], sig)
    assert {k: v.tolist() for k, v in got[1].items()} == {"s": [1.0, 4.0], "t": [2.0, 2.0]}
    assert tcal.load_qscales(tcal.qscales_cache_key(ck, TINY_ARGS, grid(4), RES, 1.1,
                                                    "blur")) is None
    m = tcal.merge_qscales(a, b)
    assert m[1]["s"].tolist() == [3.0, 4.0] and m[1]["t"].tolist() == [2.0, 5.0]
    with pytest.raises(ValueError, match="sigma grids"):
        tcal.merge_qscales(a, (sig * 2, b[1]))


def test_bench_qscales_calibrates_once_then_hits_the_cache(tmp_path, monkeypatch):
    """The benchmark's table at 32 px: two seeded draws max-merged, one
    stage per distinct sigma of the 3-step Heun schedule, written beside the
    checkpoint; a second call reads it back without calibrating, and a
    different number of steps (another sigma grid) calibrates anew."""
    _, _, tm = quant_pair("int8")
    ck = str(tmp_path / "ck.pt")
    kw = dict(res=RES, batch=2, dtype=torch.float32, n_draws=2, device="cpu")
    draws = []
    real = tcal.calibrate_qscales

    def counted(*a, **k):
        draws.append(real(*a, **k))
        return draws[-1]
    monkeypatch.setattr(tcal, "calibrate_qscales", counted)
    sig, table = tcal.bench_qscales(ck, TINY_ARGS, tm.state_dict(), num_steps=3, **kw)
    assert len(draws) == 2 and sig.shape == (3,) and np.all(np.diff(sig) > 0)
    assert sorted(table) == sorted(n for n, m in tm.named_modules() if isinstance(m, _QuantSite))
    for k, v in table.items():
        np.testing.assert_array_equal(v, np.maximum(draws[0][1][k], draws[1][1][k]))
        assert np.all(np.isfinite(v)) and np.all(v > 0), k
    assert len(list(tmp_path.glob("ck.pt.qscales.*.npz"))) == 1

    def refuse(*a, **k):
        raise AssertionError("calibrated although the table is cached")
    monkeypatch.setattr(tcal, "calibrate_qscales", refuse)
    sig2, table2 = tcal.bench_qscales(ck, TINY_ARGS, tm.state_dict(), num_steps=3, **kw)
    np.testing.assert_array_equal(sig2, sig)
    assert {k: v.tolist() for k, v in table2.items()} == {k: v.tolist() for k, v in table.items()}
    with pytest.raises(AssertionError, match="calibrated although"):
        tcal.bench_qscales(ck, TINY_ARGS, tm.state_dict(), num_steps=4, **kw)
