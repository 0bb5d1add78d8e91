"""Port parity for the measurement operators, masks, noise models, resize
matrices and blur-kernel synthesis: the same seeded numpy inputs through the
JAX package and the port on the CPU, at 32 and 64 px.

* Each operator's noiseless forward and transpose within 1e-6 of the JAX
  package's, relative to the output's largest magnitude, and its adjoint
  identity <A x, y> = <x, A^T y>.
* The resize matrices bitwise equal (the same float64 host code).
* Masks are drawn from a ``torch.Generator`` and cannot equal the JAX
  package's ``jax.random`` draws: their semantics are held instead, and the
  inpainting parity passes one explicit mask to both operators.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.operators import assets as jassets
from free_hunch_tpu.operators import blurkernel as jbk
from free_hunch_tpu.operators import get_operator as jget
from free_hunch_tpu.operators import resize as jresize
from free_hunch_tpu.ops import fftops as jfft
from free_hunch_tpu_torch.operators import assets as tassets
from free_hunch_tpu_torch.operators import blurkernel as tbk
from free_hunch_tpu_torch.operators import get_noise
from free_hunch_tpu_torch.operators import get_operator as tget
from free_hunch_tpu_torch.operators import masks as tmasks
from free_hunch_tpu_torch.operators import resize as tresize
from free_hunch_tpu_torch.ops import fftops as tfft
from tests._torch_parity import one_thread  # noqa: F401

F32 = np.float32
B = 2


def _mask(res, seed=0):
    rng = np.random.default_rng(seed)
    return np.repeat((rng.uniform(size=(1, 1, res, res)) > 0.25).astype(F32), 3, axis=1)


def _pair(name, res, **kw):
    kw = dict(kw, in_shape=(1, 3, res, res), sigma_s=0.1)
    if name == "inpainting":
        kw["mask"] = _mask(res)
    return jget(name, **kw), tget(name, device="cpu", **kw)


LINEAR = ["noise", "colorization", "gaussian_blur", "motion_blur", "super_resolution",
          "inpainting"]


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("res", [32, 64])
@pytest.mark.parametrize("name", LINEAR)
def test_forward_and_transpose_match_jax(name, res):
    jo, to = _pair(name, res)
    rng = np.random.default_rng(res)
    x = rng.normal(size=(B, 3, res, res)).astype(F32)
    y = rng.normal(size=(B,) + tuple(to.out_shape[1:])).astype(F32)
    assert tuple(to.out_shape) == tuple(np.asarray(jo.forward(jnp.asarray(x[:1]),
                                                              noiseless=True)).shape)
    _close(to.forward(torch.as_tensor(x), noiseless=True).numpy(),
           jo.forward(jnp.asarray(x), noiseless=True))
    _close(to.transpose(torch.as_tensor(y)).numpy(), jo.transpose(jnp.asarray(y)))


@pytest.mark.parametrize("name", LINEAR)
def test_adjoint_identity(name):
    _, to = _pair(name, 32)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(B, 3, 32, 32)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(B,) + tuple(to.out_shape[1:])), dtype=torch.float32)
    lhs = torch.sum(to.forward(x, noiseless=True).double() * y.double())
    rhs = torch.sum(x.double() * to.transpose(y).double())
    assert abs(float(lhs - rhs)) <= 1e-5 * float(torch.abs(lhs) + torch.abs(rhs))


@pytest.mark.parametrize("res", [32, 64])
def test_super_resolution_fft_surrogate_matches_jax(res):
    jo, to = _pair("super_resolution", res)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 3, res, res)).astype(F32)
    y = rng.normal(size=(B, 3, res // 4, res // 4)).astype(F32)
    _close(to.fft_forward(torch.as_tensor(x)).numpy(), jo.fft_forward(jnp.asarray(x)))
    _close(to.fft_transpose(torch.as_tensor(y)).numpy(), jo.fft_transpose(jnp.asarray(y)))
    for a, b in zip(to.pre_calculated[:3], jo.pre_calculated[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("args", [(256, 64, 0.25, "cubic"), (64, 16, 0.25, "cubic"),
                                  (32, 16, 0.5, "cubic"), (48, 16, 1 / 3, "cubic"),
                                  (16, 32, 2.0, "cubic"), (32, 8, 0.25, "linear"),
                                  (32, 16, 0.5, "lanczos3"), (32, 16, 0.5, "box")])
def test_resize_matrices_bitwise(args):
    np.testing.assert_array_equal(tresize.resize_matrix(*args), jresize.resize_matrix(*args))
    n_in, _, scale, kernel = args
    jr = jresize.build_resizer((n_in, n_in), scale, kernel)
    tr = tresize.build_resizer((n_in, n_in), scale, kernel, device="cpu")
    for a, b in zip(tr.matrices, jr.matrices):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(0).normal(size=(B, 3, n_in, n_in)).astype(F32)
    _close(tr(torch.as_tensor(x)).numpy(), jr(jnp.asarray(x)))


@pytest.mark.parametrize("seed", range(4))
def test_random_mask_semantics(seed):
    """Exactly floor(H*W*p) masked pixels, p ~ U(range) drawn first from the
    generator; the same pixels masked on every channel; 0/1 values."""
    lo, hi, size = 0.1, 0.3, 64
    p = lo + (hi - lo) * float(torch.rand((), generator=torch.Generator().manual_seed(seed),
                                          dtype=torch.float64))
    m = tmasks.generate_mask(torch.Generator().manual_seed(seed),
                             {"mask_type": "random", "image_size": size,
                              "mask_prob_range": (lo, hi)}, channels=3)
    assert m.shape == (1, 3, size, size) and m.dtype == torch.float32
    assert set(torch.unique(m).tolist()) <= {0.0, 1.0}
    assert torch.equal(m[:, :1].expand_as(m), m)
    assert lo <= p <= hi
    assert int((m[0, 0] == 0).sum()) == int(size * size * p)
    again = tmasks.random_pixel_mask(torch.Generator().manual_seed(seed), size, (lo, hi))
    assert torch.equal(again, m)


@pytest.mark.parametrize("seed", range(4))
def test_box_mask_semantics(seed):
    """One zero box, side in [lo, hi), at least ``margin`` inside the border
    on every side; 'extreme' is its complement for the same draw."""
    size, lo, hi, margin = 64, 8, 24, (6, 10)
    opt = {"mask_type": "box", "image_size": size, "mask_len_range": (lo, hi),
           "margin": margin}
    m = tmasks.generate_mask(torch.Generator().manual_seed(seed), opt)
    assert torch.equal(m[:, :1].expand_as(m), m)
    rows = torch.nonzero((m[0, 0] == 0).any(dim=1)).flatten()
    cols = torch.nonzero((m[0, 0] == 0).any(dim=0)).flatten()
    t, h = int(rows[0]), len(rows)
    left, w = int(cols[0]), len(cols)
    assert int((m[0, 0] == 0).sum()) == h * w    # a full rectangle
    assert lo <= h < hi and lo <= w < hi
    assert t >= margin[0] and t + h <= size - margin[0]
    assert left >= margin[1] and left + w <= size - margin[1]
    ext = tmasks.generate_mask(torch.Generator().manual_seed(seed),
                               dict(opt, mask_type="extreme"))
    assert torch.equal(ext, 1.0 - m)
    with pytest.raises(ValueError, match="mask_type"):
        tmasks.generate_mask(None, dict(opt, mask_type="ring"))


def test_inpainting_explicit_mask_and_noise_before_masking():
    jo, to = _pair("inpainting", 32)
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(B, 3, 32, 32)), dtype=torch.float32)
    y = to.forward(x, generator=torch.Generator().manual_seed(0))
    assert torch.all(y[to.mask.expand_as(y) == 0] == 0)
    assert not torch.equal(y, to.forward(x, noiseless=True))
    drawn = tget("inpainting", sigma_s=0.1, device="cpu", in_shape=(1, 3, 32, 32),
                 mask_opt={"mask_type": "random", "image_size": 32, "mask_prob_range": (0.2, 0.4)},
                 mask_generator=torch.Generator().manual_seed(2))
    assert drawn.mask.shape == (1, 3, 32, 32)


@pytest.mark.parametrize("res", [32, 64])
def test_phase_retrieval_amplitude_and_gradient_match_jax(res):
    """The amplitude, and DPS's gradient of ||y - |F pad(x)|||, also at
    x = 0 where every |z| is 0: both packages give the gradient 0 there."""
    jo, to = _pair("phase_retrieval", res)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 3, res, res)).astype(F32)
    y = rng.uniform(0, 2, size=(B,) + tuple(to.out_shape[1:])).astype(F32)
    _close(to.forward(torch.as_tensor(x), noiseless=True).numpy(),
           jo.forward(jnp.asarray(x), noiseless=True))
    for x_in in (x, np.zeros_like(x)):
        def jloss(v):
            return jnp.sqrt(jnp.sum((jnp.asarray(y) - jo.forward(v, noiseless=True)) ** 2))
        want = np.asarray(jax.grad(jloss)(jnp.asarray(x_in)))
        xt = torch.as_tensor(x_in).requires_grad_(True)
        loss = torch.sqrt(torch.sum((torch.as_tensor(y) - to.forward(xt, noiseless=True)) ** 2))
        (got,) = torch.autograd.grad(loss, xt)
        assert np.isfinite(got.numpy()).all()
        _close(got.numpy(), want, rel=1e-5)
    assert not np.abs(want).any()


def test_fftops_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, 3, 32, 32)).astype(F32)
    z = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    for tf, jf, a in ((tfft.upsample, jfft.upsample, x[..., :8, :8]),
                      (tfft.downsample, jfft.downsample, x),
                      (tfft.splits, jfft.splits, x)):
        _close(tf(torch.as_tensor(a), 4).numpy(), jf(jnp.asarray(a), 4))
    _close(tfft.fft2c(torch.as_tensor(z)).numpy(), jfft.fft2c(jnp.asarray(z)), rel=1e-5)
    _close(tfft.ifft2c(torch.as_tensor(z)).numpy(), jfft.ifft2c(jnp.asarray(z)), rel=1e-5)
    r = tfft.rfft2(torch.as_tensor(x))
    _close(r.numpy(), jfft.rfft2(jnp.asarray(x)), rel=1e-5)
    _close(tfft.irfft2(r, s=(32, 32)).numpy(), x, rel=1e-5)


def test_blur_kernel_synthesis_bitwise():
    np.testing.assert_array_equal(tbk.gaussian_kernel(61, 3.0), jbk.gaussian_kernel(61, 3.0))
    for seed, intensity in ((0, 0.5), (3, 0.1), (11, 0.9)):
        np.testing.assert_array_equal(tbk.motion_kernel(61, intensity, rng=seed),
                                      jbk.motion_kernel(61, intensity, rng=seed))
        np.testing.assert_array_equal(tbk.make_kernel("motion", 31, intensity, rng=seed),
                                      jbk.make_kernel("motion", 31, intensity, rng=seed))
    with pytest.raises(ValueError, match="blur_type"):
        tbk.make_kernel("disk", 9, 1.0)


def test_assets_equal_jax():
    for sf in (2, 3, 4, 8):
        np.testing.assert_array_equal(tassets.bicubic_sr_kernel(sf), jassets.bicubic_sr_kernel(sf))
    t, j = tassets.recon_mse(), jassets.recon_mse()
    for k in ("sigmas", "mse_list"):
        np.testing.assert_array_equal(t[k], j[k])


def test_noise_models_and_registry_errors():
    x = torch.linspace(-1, 1, 4096).reshape(1, 1, 64, 64)
    assert torch.equal(get_noise("clean")(x), x)
    g = get_noise("gaussian", sigma=0.1)(x, torch.Generator().manual_seed(0)) - x
    assert abs(float(g.std()) - 0.1) < 0.01 and abs(float(g.mean())) < 0.01
    p = get_noise("poisson", rate=1.0)(x, torch.Generator().manual_seed(0))
    assert float(p.min()) >= -1 and float(p.max()) <= 1 and not torch.equal(p, x)
    for name in ("gaussian", "poisson"):
        with pytest.raises(ValueError, match="Generator"):
            get_noise(name)(x)
    with pytest.raises(NameError):
        get_noise("speckle")
    with pytest.raises(NameError):
        tget("deconvolution", device="cpu")
    with pytest.raises(NotImplementedError, match="KernelWizard"):
        tget("nonlinear_blur", device="cpu")
