"""The port's evaluation driver (``free_hunch_tpu_torch/eval.py``,
``eval_ddnm.py`` and ``generate_conditional.py``) against the JAX
package's ``free_hunch_tpu/eval.py`` and ``eval_ddnm.py``, at 32 px on
three of the bundled ImageNet images (``resolution=32``: PIL's LANCZOS in
both packages), ``batch_size=2`` (a ragged last batch of one), with the
JAX evaluator's random UNet weights loaded into the port's.

The same random draws go into both drivers: the initial noise and the
inpainting masks are numpy draws injected through each driver's
``_gen_noise`` and ``_gen_masks`` (the JAX DDNM+ driver draws its masks in
``_make_operator``, which the test replaces with the same construction);
the port's measurement noise and DDNM+ step noise come from its own
per-batch generators (``Evaluator._generator``), and the test replays
those draws into the JAX driver through an instance override of
``_run_batch`` that otherwise does what the JAX ``_batch_fn`` does.

Limits:
* the float samples: those of ``tests/test_torch_freehunch.py::
  test_conditional_sampler_matches_jax`` (1e-4 of the JAX run's largest
  |x| after its first step) for the EDM driver, and those of
  ``tests/test_torch_ddnm.py`` (2e-5 of the largest |x|) for DDNM+;
* the saved uint8 images: at most one code apart on at most 0.5 % of the
  values (a float on a rounding boundary may land on either side);
* every journal record and the totals: 1e-2 dB PSNR, 1e-4 SSIM and LPIPS;
* the artifact layout: equal file by file.

The JAX evaluator compiles its batch function once per batch shape, two
here. With Free Hunch on the gaussian blur that case takes ~60 s alone on
the CPU, which would put this file near two minutes, so it is ``slow``; the fast tier runs DPS and DDNM+ on inpainting
with fresh masks per image; ``tests/test_torch_eval_resume.py`` holds the
port's Free Hunch driver through resume and FID replay, and
``chip_smoke.py``'s phase 5a on the card. DPS takes 3 Heun
steps, not 2: with 2, the first step's Heun corrector runs at sigma 0.002
right after sigma 80, where DPS's x reaches |x| ~ 7e5, and the float32 ulps
of that state (0.0625) reach the final samples (0.03125 apart, 4 codes on
0.1 % of the values, in both packages' arithmetic alike).
"""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from free_hunch_tpu import config as jcfg
from free_hunch_tpu.eval import Evaluator as JEvaluator
from free_hunch_tpu.eval_ddnm import DDNMEvaluator as JDDNMEvaluator
from free_hunch_tpu.models import loading as jloading
from free_hunch_tpu.operators import svd as jsvd
from free_hunch_tpu.samplers import ddnm as jddnm
from free_hunch_tpu.samplers import edm as jedm
from free_hunch_tpu_torch import config as tcfg
from free_hunch_tpu_torch.eval import Evaluator as TEvaluator
from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator as TDDNMEvaluator
from free_hunch_tpu_torch.models.convert import state_dict_from_flax
from free_hunch_tpu_torch.samplers import ddnm as tddnm
from tests._torch_parity import one_thread, tiny_pair  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data", "imagenet", "00000")
RES = 32
SETUP32 = ("--channel_mult 1,2 --attention_resolutions 8 --class_cond False "
           "--diffusion_steps 1000 --dropout 0.0 --image_size 32 --learn_sigma True "
           "--noise_schedule linear --num_channels 32 --num_head_channels 16 "
           "--num_res_blocks 1 --resblock_updown True --use_fp16 False "
           "--use_scale_shift_norm True --use_new_attention_order False")


@pytest.fixture(scope="module")
def setup32(tmp_path_factory):
    """The setup file of the 32 px UNet, beside a checkpoint path that does
    not exist but whose JAX random-init cache holds ``tiny_pair()``'s
    weights: the JAX ``load_model`` reads that cache instead of a 30 s
    eager init, and the same weights are then loaded into the port."""
    d = tmp_path_factory.mktemp("models")
    (d / "setup32.txt").write_text(SETUP32)
    arch = hashlib.md5(repr(sorted(jloading.parse_setup_txt(SETUP32).items()))
                       .encode()).hexdigest()[:10]
    jloading.save_params_npz(str(d / f"missing.pt.random0.{arch}.npz"), tiny_pair()[1])
    return str(d / "setup32.txt")


def _args(tmp_path, setup32, outdir, **over):
    args = dict(outdir=str(tmp_path / outdir),
                openai_state_dict_path=os.path.join(os.path.dirname(setup32), "missing.pt"),
                openai_setup_path=setup32, allow_random_init=True, dataset_path=DATA,
                total_images=3, batch_size=2, num_steps=2, seeds=[0],
                conditioning_mechanism="dps", operator_name="inpainting",
                noise_sigma=0.05, mesh_shape="data:1", dtype="float32", cg_maxiter=20,
                num_other_images_to_save=10, save_images=True)
    args.update(over)
    return args


def noise_for(seed: int) -> np.ndarray:
    return np.random.default_rng(1000 + seed).normal(size=(3, RES, RES)).astype(np.float32)


def mask_for(g: int) -> np.ndarray:
    """A random-pixel mask of image g, p ~ U(0.1, 0.3), shared by the
    channels, (3, H, W) float32 with 1 = observed."""
    rng = np.random.default_rng(2000 + g)
    keep = np.ones(RES * RES, np.float32)
    keep[rng.permutation(RES * RES)[:int(RES * RES * rng.uniform(0.1, 0.3))]] = 0
    return np.broadcast_to(keep.reshape(1, RES, RES), (3, RES, RES)).copy()


def _measured(op, cond, n, sigma, inpainting: bool):
    """The JAX operator's noisy forward with the draw ``n`` in place of its
    own: noise is added before the mask for inpainting, after A otherwise."""
    if inpainting:
        return op.forward(cond + sigma * jnp.asarray(n), noiseless=True)
    return op.forward(cond, noiseless=True) + sigma * jnp.asarray(n)


def _drive_pair(tmp_path, setup32, ddnm=False, **over):
    """Both drivers on the same weights and draws; returns (jax results,
    port results, jax float samples, port float samples, jax first-step
    samples) with the samples listed per batch."""
    jargs = _args(tmp_path, setup32, "jax", **over)
    targs = _args(tmp_path, setup32, "port", **over)
    with jax.enable_x64(False):
        jev = (JDDNMEvaluator if ddnm else JEvaluator)(jcfg.load_config(args=jargs))
    tev = (TDDNMEvaluator if ddnm else TEvaluator)(tcfg.load_config(args=targs), device="cpu")
    assert np.array_equal(jax.tree.leaves(jev.params)[0], jax.tree.leaves(tiny_pair()[1])[0])
    tev.model.load_state_dict(state_dict_from_flax(jev.params, tev.model.cfg))
    inpainting = jev.is_inpainting
    seeds = list(jev.seeds)

    jev._gen_noise = lambda s: jnp.asarray(np.stack([noise_for(int(v)) for v in np.asarray(s)]))
    tev._gen_noise = lambda s: torch.as_tensor(np.stack([noise_for(int(v)) for v in s]))
    key2g = {np.asarray(jax.random.fold_in(jev._key_mask, g)).tobytes(): g for g in range(3)}
    jmasks = lambda keys: [mask_for(key2g[np.asarray(k).tobytes()]) for k in keys]  # noqa: E731
    jev._gen_masks = lambda keys: jnp.asarray(np.stack(jmasks(keys)))
    tev._gen_masks = lambda gidx: torch.as_tensor(np.stack([mask_for(g) for g in gidx]))
    if ddnm and inpainting:
        jev._make_operator = lambda keys: jsvd.Inpainting(
            3, RES, [np.where(m.reshape(-1) == 0)[0] for m in jmasks(keys) for _ in seeds])

    jx, tx, jfirst = [], [], []
    counter = [0]

    if ddnm:
        n_steps = len(tddnm.ddnm_steps(jev.num_steps))

        def jrun(params, noise, cond, op, key, labels=None):
            nb, b = counter[0], noise.shape[0]
            counter[0] += 1
            flat = cond.reshape(b, -1)
            y0 = op.A(flat)
            n = torch.randn(tuple(y0.shape), generator=tev._generator("measure", nb))
            y = y0 + jev.sigma_y * jnp.asarray(n.numpy())
            gen = tev._generator("sample", nb)
            seq = np.stack([torch.randn(tuple(noise.shape), generator=gen).numpy()
                            for _ in range(n_steps)])
            x, _ = jddnm.ddnm_sample(
                lambda v, t: jev.model.apply(params, v, t, y=labels)[:, :3], op, noise, y,
                num_steps=jev.num_steps, sigma_y=jev.sigma_y, eta=jev.eta,
                noise_seq=jnp.asarray(seq))
            jx.append(np.asarray(x))
            return x, None, op.A_with_zeros(flat).reshape(cond.shape)
    else:
        def scan(params, noise, y, op, key):
            return jedm.sample_scan(lambda v, s: jev.precond.apply(params, v, s),
                                    jev._mech_builder(op), noise, y, jev.xs, key,
                                    sigma0_scaled=jev.sigma0_scaled, return_trajectory=True)

        jscan = jax.jit(scan)

        def jrun(params, noise, cond, op, key, labels=None):
            nb = counter[0]
            counter[0] += 1
            clean = op.forward(cond, noiseless=True)
            n = torch.randn(tuple(clean.shape), generator=tev._generator("measure", nb))
            y = _measured(op, cond, n.numpy(), op.sigma_s, inpainting)
            x, traj = jscan(params, noise, y, op, key)
            jx.append(np.asarray(x))
            jfirst.append(np.asarray(traj[0]))
            return x, None, y
    jev._run_batch = jrun

    batch_fn = tev._batch_fn

    def trun(*a, **k):
        out = batch_fn(*a, **k)
        tx.append(out[0].numpy().copy())
        return out
    tev._batch_fn = trun

    with jax.enable_x64(False):
        jres = jev.run()
    tres = tev.run()
    return jres, tres, jx, tx, jfirst


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _journal(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_pair(tmp_path, jres, tres, jx, tx, lims):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert len(jx) == len(tx) == 2
    for j, t, lim in zip(jx, tx, lims):
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=lim)
    assert _files(tdir) == _files(jdir)
    for name in _files(tdir):
        if name.endswith(".png"):
            a = np.asarray(PIL.Image.open(os.path.join(tdir, name)).convert("RGB"), np.int64)
            b = np.asarray(PIL.Image.open(os.path.join(jdir, name)).convert("RGB"), np.int64)
            d = np.abs(a - b)
            assert d.max() <= 1 and (d > 0).mean() <= 0.005, (name, d.max(), (d > 0).mean())
    jj, tj = _journal(os.path.join(jdir, "metrics_rank00.jsonl")), \
        _journal(os.path.join(tdir, "metrics_rank00.jsonl"))
    assert [r["batch"] for r in tj] == [r["batch"] for r in jj]
    assert [r["n"] for r in tj] == [r["n"] for r in jj] == [2, 1]
    for t, j in list(zip(tj, jj)) + [(tres, jres)]:
        assert abs(t["psnr"] - j["psnr"]) <= 1e-2
        assert abs(t["ssim"] - j["ssim"]) <= 1e-4
        assert abs(t["lpips"] - j["lpips"]) <= 1e-4
    # the totals are the sample-weighted means of the records
    for k in ("psnr", "ssim", "lpips"):
        assert tres[k] == pytest.approx((2 * tj[0][k] + tj[1][k]) / 3, rel=1e-12)
    for k in ("images", "resumed_batches", "lpips_is_proxy"):
        assert tres[k] == jres[k]
    assert tres["images"] == 3 and tres["lpips_is_proxy"] is True
    with open(os.path.join(tdir, "results.txt")) as f:
        assert f.read().startswith("PSNR: ")


def test_dps_inpainting_matches_jax(tmp_path, setup32):
    jres, tres, jx, tx, jfirst = _drive_pair(tmp_path, setup32, num_steps=3)
    _check_pair(tmp_path, jres, tres, jx, tx, [1e-4 * np.abs(f).max() for f in jfirst])


def test_ddnm_inpainting_matches_jax(tmp_path, setup32):
    jres, tres, jx, tx, _ = _drive_pair(tmp_path, setup32, ddnm=True, num_steps=3,
                                        noise_sigma=0.1)
    _check_pair(tmp_path, jres, tres, jx, tx, [2e-5 * np.abs(j).max() for j in jx])


@pytest.mark.slow
def test_free_hunch_gaussian_blur_matches_jax(tmp_path, setup32):
    jres, tres, jx, tx, jfirst = _drive_pair(
        tmp_path, setup32, conditioning_mechanism="online_covariance",
        operator_name="gaussian_blur", image_base_covariance="dct_diagonal_noinfo",
        num_steps=3, noise_sigma=0.1, cov_capacity="auto")
    _check_pair(tmp_path, jres, tres, jx, tx, [1e-4 * np.abs(f).max() for f in jfirst])


def _entry_options(name: str) -> dict:
    """The options of one command of ``tools/paper_configs.py``, typed by
    the port's config schema."""
    from free_hunch_tpu_torch.tools.paper_configs import COMMANDS
    keys = [a[2:].split("=", 1)[0] for a in COMMANDS[name]]
    opts = tcfg.load_config(argv=["--outdir=unused"] + COMMANDS[name])
    return {k: opts[k] for k in keys}


@pytest.mark.slow
def test_free_hunch_motion_blur_matches_jax(tmp_path, setup32):
    """The paper's headline command (``freehunch_motion``: the motion blur,
    the DCT-diagonal prior, the tailored CG, the space-update window) through
    both drivers, with the gaussian-blur case's limits."""
    jres, tres, jx, tx, jfirst = _drive_pair(
        tmp_path, setup32, **dict(_entry_options("freehunch_motion"),
                                  image_base_covariance="dct_diagonal_noinfo"), num_steps=3,
        noise_sigma=0.1, cov_capacity="auto")
    _check_pair(tmp_path, jres, tres, jx, tx, [1e-4 * np.abs(f).max() for f in jfirst])
