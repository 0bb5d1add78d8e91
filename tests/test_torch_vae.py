"""The port's SD-VAE (``free_hunch_tpu_torch/models/vae.py``, the VAE part
of ``models/convert.py`` and ``data/encoders.py::StabilityVAEEncoder``)
against the JAX package's ``free_hunch_tpu/models/vae.py`` and
``data/encoders.py``, on the CPU.

The narrow config of ``tests/test_vae.py`` (``block_out_channels`` (32,
64), one ResNet block per level, 8 groups) at 32 px, with random flax
parameters drawn from a numpy seed and carried across with
``vae_state_dict_from_flax``. Limits: ``encode``'s mean and std and
``decode``'s pixels within 1e-5 of each output's largest |value| (both in
float32); the encoder's uint8 at most one code apart on at most 0.5 % of
the values (a float on a truncation boundary may land on either side); the
full sd-vae-ft-mse layout by its parameter shapes and count alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.data import encoders as jenc
from free_hunch_tpu.models import loading as jloading
from free_hunch_tpu.models import vae as jvae
from free_hunch_tpu_torch.data.encoders import StabilityVAEEncoder
from free_hunch_tpu_torch.models import convert
from free_hunch_tpu_torch.models.vae import (AutoencoderKL, VAEConfig, VAEGroupNorm,
                                             load_diffusers_state_dict)
from tests._torch_parity import one_thread  # noqa: F401

TCFG = VAEConfig(block_out_channels=(32, 64), layers_per_block=1, latent_channels=4,
                 norm_num_groups=8)
JCFG = jvae.VAEConfig(block_out_channels=(32, 64), layers_per_block=1, latent_channels=4,
                      norm_num_groups=8)
RES = 32


def random_flax_params(cfg, seed=0, res=RES):
    """Flax parameters of ``cfg`` from a numpy seed: fan-in-scaled kernels,
    biases 0.1 N(0, 1), GroupNorm scales 1 + 0.1 N(0, 1)."""
    shapes = jax.eval_shape(jvae.AutoencoderKL(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, res, res)), jax.random.PRNGKey(1))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    params = random_flax_params(JCFG, seed=7)
    port = AutoencoderKL(TCFG)
    port.load_state_dict(convert.vae_state_dict_from_flax(params), strict=True)
    return jvae.AutoencoderKL(JCFG), params, port.eval().requires_grad_(False)


def close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, lim = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= lim, (err, lim)


def test_encode_matches_jax(pair):
    jm, params, port = pair
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, RES, RES)).astype(np.float32)
    mean_j, std_j = jax.jit(lambda p, v: jm.apply(p, v, method="encode"))(params, x)
    with torch.no_grad():
        mean_t, std_t = port.encode(torch.from_numpy(x))
    assert mean_t.shape == (2, 4, 16, 16)
    close(mean_t, mean_j)
    close(std_t, std_j)


def test_decode_matches_jax(pair):
    jm, params, port = pair
    z = np.random.default_rng(1).standard_normal((3, 4, 16, 16)).astype(np.float32)
    out_j = jax.jit(lambda p, v: jm.apply(p, v, method="decode"))(params, z)
    with torch.no_grad():
        out_t = port.decode(torch.from_numpy(z))
    assert out_t.shape == (3, 3, RES, RES)
    close(out_t, out_j)


def test_logvar_clamp_matches_jax(pair):
    """Large inputs drive the log-variance past the clamp on both sides."""
    jm, params, port = pair
    x = (np.random.default_rng(2).standard_normal((1, 3, RES, RES)) * 50).astype(np.float32)
    _, std_j = jax.jit(lambda p, v: jm.apply(p, v, method="encode"))(params, x)
    with torch.no_grad():
        _, std_t = port.encode(torch.from_numpy(x))
    close(std_t, std_j)


def diffusers_state_dict(params, legacy: bool):
    """The JAX package's inverse: flax params -> a diffusers-layout torch
    state dict, modern or legacy naming, from the JAX converter's own map
    (``params_from_torch_state_dict`` reads these names)."""
    sd = convert.vae_state_dict_from_flax(params)
    if not legacy:
        return sd
    out = {}
    for k, v in sd.items():
        for new, old in [(".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
                         (".to_out.0.", ".proj_attn."), (".group_norm.", ".norm."),
                         (".conv_shortcut.", ".nin_shortcut.")]:
            if new in k:
                k = k.replace(new, old)
                if old not in (".norm.", ".nin_shortcut.") and k.endswith(".weight"):
                    v = v[:, :, None, None]  # the legacy 1x1 convolutions
                break
        out[k] = v
    return out


@pytest.mark.parametrize("legacy", [False, True])
def test_load_diffusers_state_dict_equals_the_flax_converter(pair, legacy):
    """Both namings load into the same module as the flax converter gives,
    and the JAX package's own converter reads the same state dict into the
    same flax parameters."""
    _, params, port = pair
    sd = diffusers_state_dict(params, legacy)
    got = load_diffusers_state_dict(AutoencoderKL(TCFG), sd).state_dict()
    want = port.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    back = jvae.params_from_torch_state_dict({k: v.numpy() for k, v in sd.items()}, JCFG)
    for k, v in convert.vae_state_dict_from_flax(back).items():
        assert torch.equal(v, want[k]), k


def test_load_diffusers_state_dict_is_strict(pair):
    sd = dict(pair[2].state_dict())
    sd.pop("encoder.conv_in.bias")
    with pytest.raises(RuntimeError, match="conv_in.bias"):
        load_diffusers_state_dict(AutoencoderKL(TCFG), sd)


def test_the_full_layout_equals_jax():
    """sd-vae-ft-mse (``VAEConfig()``): 83,653,863 parameters, 52
    GroupNorms (22 encoder, 30 decoder), every tensor's name and shape
    those the JAX package's parameters convert to."""
    shapes = jax.eval_shape(jvae.AutoencoderKL(jvae.VAEConfig()).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 16, 16)), jax.random.PRNGKey(1))
    want = {k: tuple(v.shape) for k, v in convert.vae_state_dict_from_flax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    port = AutoencoderKL(VAEConfig())
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert sum(p.numel() for p in port.parameters()) == 83_653_863
    norms = [n for n, m in port.named_modules() if isinstance(m, VAEGroupNorm)]
    assert len(norms) == 52 and sum(n.startswith("encoder.") for n in norms) == 22


def test_the_interior_is_channels_last(pair):
    """On ``to_device`` the modules and activations are channels-last, so
    each norm's NHWC view is contiguous: no norm copies."""
    port = AutoencoderKL(TCFG)
    port.load_state_dict(pair[2].state_dict())
    port.to_device("cpu")
    seen = []
    for m in port.modules():
        if isinstance(m, VAEGroupNorm):
            m.register_forward_pre_hook(
                lambda mod, a: seen.append(a[0].permute(0, 2, 3, 1).is_contiguous()))
    with torch.no_grad():
        port.encode(torch.rand(1, 3, RES, RES))
        port.decode(torch.rand(1, 4, 16, 16))
    assert len(seen) == 10 + 14 and all(seen)  # every norm of the narrow config


# -- StabilityVAEEncoder ---------------------------------------------------------

def jax_encoder(params, batch_size):
    enc = jenc.StabilityVAEEncoder(batch_size=batch_size)
    enc._vae = jvae.AutoencoderKL(JCFG)
    enc._params = params
    enc._enc = jax.jit(lambda p, x: enc._vae.apply(p, x, method="encode"))
    enc._dec = jax.jit(lambda p, z: enc._vae.apply(p, z, method="decode"))
    return enc


@pytest.fixture(scope="module")
def encoders(pair):
    params = pair[1]
    port = StabilityVAEEncoder(batch_size=2, cfg=TCFG)
    port.init(device="cpu", params=params)
    return jax_encoder(params, 2), port


def pixels(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, RES, RES), dtype=np.uint8)


def test_encode_pixels_matches_jax(encoders):
    jv, tv = encoders
    x = pixels(3)
    close(tv.encode_pixels(x), jv.encode_pixels(x))
    close(tv.encode_pixels(torch.from_numpy(x)), jv.encode_pixels(x))


def test_encode_latents_with_the_same_eps_matches_jax(encoders, monkeypatch):
    """The JAX key path is replaced by the port's draws: the same eps on
    both sides."""
    jv, tv = encoders
    raw = tv.encode_pixels(pixels(3))
    got = tv.encode_latents(raw, generator=torch.Generator().manual_seed(11))
    eps = torch.randn((3, 4, 16, 16), generator=torch.Generator().manual_seed(11)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(eps))
    want = jv.encode_latents(raw.numpy(), key=jax.random.PRNGKey(0))
    close(got, want, rel=1e-6)


def test_encode_latents_draws_fresh_noise_without_a_generator(encoders):
    tv = encoders[1]
    raw = torch.cat([torch.zeros(2, 4, 8, 8), torch.ones(2, 4, 8, 8)], dim=1)
    a, b = tv.encode_latents(raw), tv.encode_latents(raw)
    assert (a - b).abs().max() > 1e-3
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    assert torch.equal(tv.encode_latents(raw, g()), tv.encode_latents(raw, g()))


def test_decode_matches_jax_to_one_code(encoders):
    jv, tv = encoders
    z = np.random.default_rng(4).standard_normal((3, 4, 16, 16)).astype(np.float32) * 0.5
    got, want = tv.decode(z), np.asarray(jv.decode(z))
    assert got.dtype == torch.uint8 and got.shape == (3, 3, RES, RES)
    d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (d.max(), (d > 0).mean())


def test_the_empty_batch(encoders):
    jv, tv = encoders
    e = tv.encode_pixels(np.zeros((0, 3, RES, RES), np.uint8))
    assert tuple(e.shape) == tuple(jv.encode_pixels(np.zeros((0, 3, RES, RES), np.uint8)).shape) \
        == (0, 8, 16, 16)
    assert tuple(tv.encode_latents(e).shape) == (0, 4, 16, 16)
    d = tv.decode(torch.zeros(0, 4, 16, 16))
    assert d.dtype == torch.uint8 and tuple(d.shape) == (0, 3, RES, RES)


def test_batching_runs_batch_size_images_at_a_time(pair, encoders):
    tv = encoders[1]
    one = StabilityVAEEncoder(batch_size=8, cfg=TCFG)
    one.init(device="cpu", params=pair[1])
    calls = []
    enc = tv.vae.encode
    tv.vae.encode = lambda x: calls.append(x.shape[0]) or enc(x)
    try:
        x = pixels(5, seed=6)
        close(tv.encode_pixels(x), one.encode_pixels(x), rel=1e-6)
    finally:
        del tv.vae.encode
    assert calls == [2, 2, 1]
    z = tv.encode_latents(one.encode_pixels(x), torch.Generator().manual_seed(0))
    d = (tv.decode(z).int() - one.decode(z).int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 0.005


def test_weights_from_the_jax_npz(pair, encoders, tmp_path):
    """``weights`` names the JAX package's npz (``save_params_npz`` of the
    parameter tree, as its encoder reads it)."""
    path = str(tmp_path / "sd_vae.npz")
    jloading.save_params_npz(path, pair[1]["params"])
    enc = StabilityVAEEncoder(batch_size=2, cfg=TCFG, weights=path)
    enc.init(device="cpu")
    x = pixels(2)
    assert torch.equal(enc.encode_pixels(x), encoders[1].encode_pixels(x))


def test_no_weights_raises_naming_the_file(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="weights=None"):
        StabilityVAEEncoder(cfg=TCFG).init(device="cpu")
    missing = str(tmp_path / "absent.npz")
    with pytest.raises(RuntimeError, match="absent.npz"):
        StabilityVAEEncoder(cfg=TCFG, weights=missing).init(device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        StabilityVAEEncoder(cfg=TCFG).encode_pixels(pixels(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StabilityVAEEncoder(cfg=TCFG).init(params={"params": {}})
