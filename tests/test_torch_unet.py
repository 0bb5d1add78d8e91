"""Port parity for the ADM UNet, the preconditioner and the denoiser vjp,
on the 32 px f32 config of tests/test_sampler_e2e.py with the same weights
in both packages (flax init -> ``state_dict_from_flax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu.models.unet import UNetConfig as JConfig
from free_hunch_tpu.models.unet import UNetModel as JUNet
from free_hunch_tpu_torch.models import loading as tload
from free_hunch_tpu_torch.models.convert import name_map
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
from free_hunch_tpu_torch.models.unet import GroupNorm32, UNetConfig, UNetModel, create_model

from tests._torch_parity import RES, one_thread, tiny_cfg_kwargs, tiny_pair  # noqa: F401

F32 = np.float32
SETUP_256 = "models/256x256_diffusion_uncond_setup.txt"

# test_unet_parity.py:77's tolerance: f32 convs on two CPU backends
UNET_TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3, RES, RES)).astype(F32)


def test_unet_forward_matches_jax():
    jm, params, tm = tiny_pair()
    x = _inputs()
    t = np.asarray([10.0, 700.0], F32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    assert got.shape == (2, 6, RES, RES)
    np.testing.assert_allclose(got, want, **UNET_TOL)


@pytest.mark.parametrize("sigma", [0.05, 2.5, 60.0])
def test_precond_matches_jax(sigma):
    jm, params, tm = tiny_pair()
    jp = JPrecond(jm, img_resolution=RES, img_channels=3)
    tp = TPrecond(tm, img_resolution=RES, img_channels=3)
    x = _inputs(1) * sigma
    s = float(F32(sigma))
    jd, jv = jax.jit(jp.apply)(params, jnp.asarray(x), jnp.asarray(s, jnp.float32))
    td, tv = tp(torch.as_tensor(x), s)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **UNET_TOL)
    # x0_var = (v - pv) / pm1^2 magnifies the f32 conv differences of the
    # variance channel by 1/pm1^2 at small sigma: tolerance on its scale
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-4,
                               atol=2e-5 * np.abs(np.asarray(jv)).max())
    # host and tensor branches of round_sigma agree with JAX's host branch
    grid = np.asarray([0.002, s, 80.0, 3.3], F32)
    want = jp.round_sigma(grid, return_index=True)
    np.testing.assert_array_equal(tp.round_sigma(grid, return_index=True), want)
    np.testing.assert_array_equal(tp.round_sigma(torch.as_tensor(grid),
                                                 return_index=True).numpy(), want)
    np.testing.assert_array_equal(tp.round_sigma(grid), jp.round_sigma(grid))


@pytest.mark.parametrize("remat", [False, True])
def test_denoiser_vjp_matches_jax(remat):
    """The guidance pullback: d(ct . x0_mean)/d x_t, against ``jax.vjp``;
    remat (checkpointed ResBlocks) must not change it."""
    jm, params, tm = tiny_pair()
    jp = JPrecond(jm, img_resolution=RES, img_channels=3)
    sigma = float(F32(1.7))
    x = _inputs(2) * 2.0
    ct = np.random.default_rng(3).normal(size=x.shape).astype(F32)
    @jax.jit
    def jvjp(v, c):
        _, pull = jax.vjp(lambda u: jp.apply(params, u, jnp.float32(sigma))[0], v)
        return pull(c)[0]

    want = np.asarray(jvjp(jnp.asarray(x), jnp.asarray(ct)))
    cfg = UNetConfig(**tiny_cfg_kwargs(), dtype=torch.float32, remat=remat)
    model = UNetModel(cfg)
    model.load_state_dict(tm.state_dict())
    model.eval().requires_grad_(False)
    tp = TPrecond(model, img_resolution=RES, img_channels=3)
    xt = torch.as_tensor(x).requires_grad_(True)
    d, _ = tp(xt, sigma)
    (got,) = torch.autograd.grad(d, xt, grad_outputs=torch.as_tensor(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


def test_state_dict_bridge_is_exact_inverse_of_convert():
    """state_dict_from_flax inverts the JAX package's convert_state_dict."""
    from free_hunch_tpu.models.convert import convert_state_dict
    _, params, tm = tiny_pair()
    cfg = JConfig(**tiny_cfg_kwargs())
    sd = tm.state_dict()
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    for (a, b) in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_256px_topology_matches_reference_names_and_norm_count():
    """The full 256 px model (built on the meta device, no memory): its
    state-dict keys are exactly the reference names, and one forward runs
    101 GroupNorms (42 ResBlocks x 2 + 16 attention norms + the out norm)."""
    with open(SETUP_256) as f:
        args = tload.parse_setup_txt(f.read())
    from free_hunch_tpu.models.loading import parse_setup_txt as jparse
    with open(SETUP_256) as f:
        assert args == jparse(f.read())
    with torch.device("meta"):
        model = create_model(**args)
    names = [n for n, _, _ in name_map(model.cfg)]
    assert sorted(names) == sorted(model.state_dict().keys())
    assert len(names) == len(set(names))
    assert sum(isinstance(m, GroupNorm32) for m in model.modules()) == 101
    n_params = sum(p.numel() for p in model.parameters())
    assert 550e6 < n_params < 555e6, n_params


def test_load_model_random_init_is_seeded_and_nondegenerate(tmp_path):
    setup = tmp_path / "setup.txt"
    setup.write_text("--attention_resolutions 8 --class_cond False --image_size 32 "
                     "--learn_sigma True --num_channels 32 --num_head_channels 16 "
                     "--num_res_blocks 1 --resblock_updown True --channel_mult 1,2 "
                     "--use_scale_shift_norm True --use_new_attention_order False")
    m1, args = tload.load_model(str(tmp_path / "missing.pt"), str(setup), device="cpu",
                                dtype=torch.float32, init_random_if_missing=True,
                                rng_seed=3)
    m2, _ = tload.load_model(str(tmp_path / "missing.pt"), str(setup), device="cpu",
                             dtype=torch.float32, init_random_if_missing=True,
                             rng_seed=3)
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
        assert float(a.abs().max()) > 0.0, k
    assert not any(p.requires_grad for p in m1.parameters())
    pre = tload.wrap_precond(m1, args)
    d, v = pre(torch.zeros(1, 3, 32, 32), 1.0)
    assert torch.isfinite(d).all() and float(d.abs().max()) > 0
    with pytest.raises(FileNotFoundError):
        tload.load_model(str(tmp_path / "missing.pt"), str(setup), device="cpu")
    # a saved state dict loads back unchanged, under the reference names
    torch.save(m1.state_dict(), tmp_path / "ck.pt")
    m3, _ = tload.load_model(str(tmp_path / "ck.pt"), str(setup), device="cpu",
                             dtype=torch.float32)
    for a, b in zip(m1.state_dict().values(), m3.state_dict().values()):
        assert torch.equal(a, b)


def test_bf16_torso_keeps_f32_norms_embedding_and_out_conv():
    model = create_model(**{**dict(image_size=32, num_channels=32, num_res_blocks=1,
                                   channel_mult="1,2", attention_resolutions="8",
                                   num_head_channels=16)})
    dt = {n: p.dtype for n, p in model.named_parameters()}
    assert dt["input_blocks.0.0.weight"] == torch.bfloat16
    assert dt["input_blocks.1.0.emb_layers.1.weight"] == torch.bfloat16
    assert dt["input_blocks.1.0.in_layers.0.weight"] == torch.float32
    assert dt["time_embed.0.weight"] == torch.float32
    assert dt["out.2.weight"] == torch.float32
    out = model(torch.randn(2, 3, 32, 32), torch.tensor([1.0, 500.0]))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
