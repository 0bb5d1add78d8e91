"""The port's UNet at the FFHQ setup's topology (``models/ffhq_10m_setup.txt``:
one res block a level, attention at ds 16, learned sigma, 128 channels)
against the JAX package's, with the same weights (flax init ->
``state_dict_from_flax``). The parity runs narrowed to 64 px and 32
channels, the 256 px ``channel_mult`` (1, 1, 2, 2, 4, 4) written out, so
attention sits at 4 px (ds 16) as at 16 px in the full model; forward and
input vjp are held to tests/test_torch_unet.py's tolerances. The full
model's topology is read on the meta device, and K1's planner is checked at
every GroupNorm call of its 256 px forward at batch 8, where a group has 4
channels and a bf16 16-byte vector spans two groups (the card's check is
``tests/test_torch_cuda_kernels.py::
test_kernel_matches_plain_at_every_ffhq_forward_shape``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.models.loading import parse_setup_txt as jparse
from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu.models.unet import create_model as jcreate
from free_hunch_tpu_torch.models import loading as tload
from free_hunch_tpu_torch.models.convert import name_map, state_dict_from_flax
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
from free_hunch_tpu_torch.models.unet import GroupNorm32, create_model
from free_hunch_tpu_torch.ops import groupnorm as gn
from tests import test_torch_gn_plan as imagenet_plan
from tests._torch_parity import _randomize_zero_leaves, one_thread  # noqa: F401
from tests.test_torch_gn_plan import SMS, norm_calls
from tests.test_torch_unet import UNET_TOL

SETUP_FFHQ = "models/ffhq_10m_setup.txt"
RES, CH = 64, 32
F32 = np.float32
FFHQ_LISTING = dict(mc=128, blocks=1, attn_res=(16,))


def _setup_args() -> dict:
    with open(SETUP_FFHQ) as f:
        text = f.read()
    args = tload.parse_setup_txt(text)
    assert args == jparse(text)
    return args


def _narrow_args() -> dict:
    return dict(_setup_args(), image_size=RES, num_channels=CH,
                channel_mult="1,1,2,2,4,4", attention_resolutions=str(RES // 16))


@pytest.fixture(scope="module")
def ffhq_pair():
    """(jax model, params, torch model) of the narrowed FFHQ topology with
    identical f32 weights."""
    args = _narrow_args()
    jm = jcreate(**args, dtype=jnp.float32, remat=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, RES, RES), jnp.float32),
                              jnp.zeros((1,), jnp.float32))
    params = jax.tree.map(jnp.asarray, _randomize_zero_leaves(params))
    tm = create_model(**args, dtype=torch.float32, remat=False)
    tm.load_state_dict(state_dict_from_flax(params, tm.cfg))
    tm.eval().requires_grad_(False)
    return jm, params, tm


def test_ffhq_setup_topology():
    """The full FFHQ model on the meta device: the reference names, 65
    GroupNorms (the listing's), one res block a level, attention at ds 16,
    learned sigma, 128 channels."""
    args = _setup_args()
    assert (args["num_channels"], args["num_res_blocks"], args["image_size"]) == (128, 1, 256)
    with torch.device("meta"):
        model = create_model(**args)
    cfg = model.cfg
    assert cfg.channel_mult == (1, 1, 2, 2, 4, 4) and cfg.attention_resolutions == (16,)
    assert cfg.out_channels == 6 and cfg.num_res_blocks == 1
    names = [n for n, _, _ in name_map(cfg)]
    assert sorted(names) == sorted(model.state_dict().keys())
    norms = sum(isinstance(m, GroupNorm32) for m in model.modules())
    assert norms == len(norm_calls(**FFHQ_LISTING)) == 65
    # 32 groups of 4 channels at the narrowest norms
    assert min(s[3] for _, s, _ in norm_calls(**FFHQ_LISTING)) == 128


def test_the_ffhq_listing_matches_the_narrow_models_calls(ffhq_pair):
    _, _, tm = ffhq_pair
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: seen.append(tuple(a[0].permute(0, 2, 3, 1).shape)))
        for m in tm.modules() if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        tm(torch.zeros(2, 3, RES, RES), torch.full((2,), 10.0))
    for h in hooks:
        h.remove()
    listed = norm_calls(batch=2, res=RES, mc=CH, blocks=1, attn_res=(RES // 16,))
    assert [s for _, s, _ in listed] == seen


def _inputs(seed=0, n=2):
    return np.random.default_rng(seed).normal(size=(n, 3, RES, RES)).astype(F32)


def test_ffhq_topology_forward_matches_jax(ffhq_pair):
    jm, params, tm = ffhq_pair
    x = _inputs()
    t = np.asarray([10.0, 700.0], F32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    assert got.shape == (2, 6, RES, RES)
    np.testing.assert_allclose(got, want, **UNET_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_ffhq_topology_denoiser_vjp_matches_jax(ffhq_pair, remat):
    jm, params, tm = ffhq_pair
    jp = JPrecond(jm, img_resolution=RES, img_channels=3)
    sigma = float(F32(1.7))
    x = _inputs(2) * 2.0
    ct = np.random.default_rng(3).normal(size=x.shape).astype(F32)

    @jax.jit
    def jvjp(v, c):
        _, pull = jax.vjp(lambda u: jp.apply(params, u, jnp.float32(sigma))[0], v)
        return pull(c)[0]

    want = np.asarray(jvjp(jnp.asarray(x), jnp.asarray(ct)))
    model = create_model(**_narrow_args(), dtype=torch.float32, remat=remat)
    model.load_state_dict(tm.state_dict())
    model.eval().requires_grad_(False)
    tp = TPrecond(model, img_resolution=RES, img_channels=3)
    xt = torch.as_tensor(x).requires_grad_(True)
    d, _ = tp(xt, sigma)
    (got,) = torch.autograd.grad(d, xt, grad_outputs=torch.as_tensor(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5 * np.abs(want).max())


FFHQ_SHAPES = sorted({(b, h * w, c, size, False)
                      for b in (8, 2, 1)
                      for _, (_, h, w, c), size in norm_calls(batch=b, **FFHQ_LISTING)})


@pytest.mark.parametrize("n,s,c,itemsize,quant", FFHQ_SHAPES,
                         ids=[f"n{n}_s{s}_c{c}_{'f32' if z == 4 else 'bf16'}"
                              for n, s, c, z, _ in FFHQ_SHAPES])
def test_k1_plan_at_every_ffhq_call(n, s, c, itemsize, quant):
    """K1's planner at the FFHQ forward's calls at batch 8, 2 and 1, under
    the ImageNet calls' invariants; at 128 bf16 channels a 16-byte vector of
    8 channels holds two groups of 4."""
    imagenet_plan.test_plan_covers_every_row_once_within_the_blocks_limits(n, s, c, itemsize,
                                                                           quant)
    plan = gn.gn_plan(n, s, c, 32, itemsize, SMS)
    if c == 128 and itemsize == 2:
        assert plan.tx == 16 and (16 // itemsize) // (c // 32) == 2
