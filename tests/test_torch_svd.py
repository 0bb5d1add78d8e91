"""Port parity for the SVD operator library (operators/svd.py) against the
JAX package's ``free_hunch_tpu/operators/svd.py``, at 32 px.

* Setup factors: both packages take numpy float64 SVDs on the host and cast
  to float32, so every factor matrix, permutation and singular-value vector
  is equal bit for bit.
* Maps: the JAX side runs with x64 off, as in production, so its DDNM+
  scalars are float32 (with x64 on, ``np.sqrt(1 - eta^2)`` promotes its
  Lambda products to float64). Operators built from gathers and additions
  only (Denoising, Inpainting, WalshHadamardCS) are then equal bit for bit,
  but for the DDNM+ factors, where XLA may contract d1's multiply-subtract
  into one fused multiply-add: those, and every Lambda, are held to 1e-6
  relative (a few ulps; observed 1 ulp on 4 of 4,095 values at 64 px).
  The other operators run f32 matmuls that sum in another order than XLA's
  einsums and are held to 1e-5 of the output's max |.| (observed <= 2.2e-6,
  the largest on Deblurring's A_pinv, which divides by singular values down
  to the 3e-2 threshold squared)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.operators import assets as jassets
from free_hunch_tpu.operators import svd as J
from free_hunch_tpu_torch.operators import masks as tmasks
from free_hunch_tpu_torch.operators import svd as T
from tests._torch_parity import one_thread  # noqa: F401

RES = 32
B = 2
RTOL = 1e-5
_RNG = np.random.default_rng(0)
_KERNEL = jassets.gaussian_blur_kernel()
_K1D = _KERNEL[30, 20:41] / _KERNEL[30, 20:41].sum()
_PERM = _RNG.permutation(16 * 16)   # WalshHadamardCS at 16 px
_DENSE = _RNG.normal(size=(20, 3 * 8 * 8))
_MISSING = _RNG.choice(3 * RES * RES, 500, replace=False)

# name -> (make(module, **device), input length, exact)
OPS = {
    "denoising": (lambda M, **d: M.Denoising(3, RES, **d), 3 * RES * RES, True),
    "inpainting": (lambda M, **d: M.Inpainting(3, RES, _MISSING, **d), 3 * RES * RES, True),
    "inpainting_per_row": (lambda M, **d: M.Inpainting(3, RES, [_MISSING, _MISSING[:120]], **d),
                           3 * RES * RES, True),
    "super_resolution_x4": (lambda M, **d: M.SuperResolution(3, RES, 4, **d),
                            3 * RES * RES, False),
    "colorization": (lambda M, **d: M.Colorization(RES, **d), 3 * RES * RES, False),
    "deblurring": (lambda M, **d: M.Deblurring(_KERNEL, 3, RES, **d), 3 * RES * RES, False),
    "deblurring_ddnm_kernel": (lambda M, **d: M.Deblurring(_KERNEL, 3, RES,
                                                           use_ddnm_kernel_params=True, **d),
                               3 * RES * RES, False),
    "deblurring_2d": (lambda M, **d: M.Deblurring2D(_KERNEL[30, 20:41], _KERNEL[30, 25:36], 3,
                                                    RES, **d), 3 * RES * RES, False),
    "srconv_x2": (lambda M, **d: M.SRConv(_K1D, 3, RES, stride=2, **d), 3 * RES * RES, False),
    "general_a": (lambda M, **d: M.GeneralA(_DENSE, **d), 3 * 8 * 8, False),
    "cs": (lambda M, **d: M.CS(3, RES, 0.25, **d), 3 * RES * RES, False),
    "walsh_hadamard_cs": (lambda M, **d: M.WalshHadamardCS(3, 16, 4, _PERM, **d),
                          3 * 16 * 16, True),
}
WITH_LAMBDA = ("denoising", "inpainting", "inpainting_per_row", "super_resolution_x4",
               "colorization", "deblurring", "deblurring_ddnm_kernel", "walsh_hadamard_cs")
# (a, sigma_y, sigma_t): sigma_y 0 (the early return), and sigma_y > 0 with
# the threshold a sigma_y / s between the operators' singular values
# ("mixed": below and above both hit where s varies) or above all of them
SIGMAS = {"sigma_y_0": (0.3, 0.0, 0.9), "mixed": (0.3, 0.05, 0.9),
          "below": (0.9, 0.05, 0.01)}


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name):
        if name not in cache:
            make = OPS[name][0]
            cache[name] = (make(J), make(T, device="cpu"))
        return cache[name]
    return get


def _close(got, want, exact, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape)
    if exact == "ulps":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=what)
    elif exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("name", sorted(OPS))
def test_setup_factors_are_bitwise_equal(built, name):
    jop, top = built(name)
    arrays = {k: v for k, v in vars(jop).items() if hasattr(v, "shape")}
    assert arrays
    for attr, want in arrays.items():
        got = getattr(top, attr)
        assert torch.is_tensor(got), attr
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=attr)
        assert got.numpy().dtype == np.asarray(want).dtype, attr


@pytest.mark.parametrize("name", sorted(OPS))
def test_maps_match_jax(built, name):
    jop, top = built(name)
    n, exact = OPS[name][1], OPS[name][2]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, n)).astype(np.float32)
    y = np.asarray(jop.A(jnp.asarray(x)))
    small = rng.normal(size=y.shape).astype(np.float32)
    with jax.enable_x64(False):
        for what, jf, tf, v in (
                ("V", jop.V, top.V, x), ("Vt", jop.Vt, top.Vt, x),
                ("U", jop.U, top.U, small), ("Ut", jop.Ut, top.Ut, small),
                ("A", jop.A, top.A, x), ("At", jop.At, top.At, small),
                ("A_pinv", jop.A_pinv, top.A_pinv, small),
                ("A_with_zeros", jop.A_with_zeros, top.A_with_zeros, x),
                ("A_pinv_eta", lambda u: jop.A_pinv_eta(u, 0.01),
                 lambda u: top.A_pinv_eta(u, 0.01), small)):
            _close(tf(torch.as_tensor(v)), jax.jit(jf)(jnp.asarray(v)), exact, what)


@pytest.mark.parametrize("sig", sorted(SIGMAS))
@pytest.mark.parametrize("eta", [1.0, 0.85])
@pytest.mark.parametrize("name", WITH_LAMBDA)
def test_lambda_and_lambda_noise_match_jax(built, name, eta, sig):
    jop, top = built(name)
    a, sigma_y, sigma_t = SIGMAS[sig]
    rng = np.random.default_rng(2)
    x, e = (rng.normal(size=(B, OPS[name][1])).astype(np.float32) for _ in range(2))
    exact = "ulps" if OPS[name][2] else False
    with jax.enable_x64(False):
        ja, jst = jnp.float32(a), jnp.float32(sigma_t)
        want = jop.Lambda(jnp.asarray(x), ja, sigma_y, jst, eta)
        got = top.Lambda(torch.as_tensor(x), np.float32(a), sigma_y, np.float32(sigma_t), eta)
        _close(got, want, exact, "Lambda")
        want = jop.Lambda_noise(jnp.asarray(x), ja, sigma_y, jst, eta, jnp.asarray(e))
        got = top.Lambda_noise(torch.as_tensor(x), np.float32(a), sigma_y, np.float32(sigma_t),
                               eta, torch.as_tensor(e))
        _close(got, want, exact, "Lambda_noise")


@pytest.mark.parametrize("eta", [1.0, 0.85, 0.2])
@pytest.mark.parametrize("sigma_y", [0.0, 0.05])
def test_ddnm_factors_with_every_mask_hit(sigma_y, eta):
    """A singular-value vector with zeros, values under the threshold
    a sigma_y / sigma_t (noisier observation: 'below') and over it ('above')."""
    s = np.asarray([0.0, 0.0, 0.004, 0.01, 0.016, 0.05, 0.3, 1.0, 0.0, 0.7], np.float32)
    a, sigma_t = np.float32(0.3), np.float32(0.9)
    thresh = a * np.float32(sigma_y) / np.where(s > 0, s, 1)
    if sigma_y:
        assert ((s > 0) & (sigma_t < thresh)).any() and ((s > 0) & (sigma_t > thresh)).any()
    with jax.enable_x64(False):
        want = J._ddnm_factors(jnp.asarray(s), jnp.float32(a), sigma_y, jnp.float32(sigma_t),
                               eta)
        got = T._ddnm_factors(torch.as_tensor(s), a, sigma_y, sigma_t, eta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    # the padded singulars helper
    np.testing.assert_array_equal(T._pad_singulars(torch.as_tensor(s[:3]), 6).numpy(),
                                  np.asarray(J._pad_singulars(jnp.asarray(s[:3]), 6)))


def test_conv1d_matrix_equals_jax():
    for k, dim in ((_K1D, 32), (_KERNEL[30], 32), (_KERNEL[30, 28:33], 16)):
        np.testing.assert_array_equal(T._conv1d_matrix(k, dim), J._conv1d_matrix(k, dim))


@pytest.mark.parametrize("m,n", [(3, 16), (2, 256)])
def test_fwht_matches_jax_and_inverts(m, n):
    a = np.random.default_rng(3).normal(size=(m, n)).astype(np.float32)
    got = T.fwht(torch.as_tensor(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(J.fwht)(jnp.asarray(a))))
    np.testing.assert_allclose(T.fwht(got).numpy() / n, a, rtol=0, atol=1e-5)


def test_deblurring_interleaves_channels():
    """Deblurring's singular values are repeat-interleaved over the channels
    (pixel-last), not tiled, so A is a per-channel blur: the same image in
    every channel gives the same output in every channel."""
    top = OPS["deblurring"][0](T, device="cpu")
    s = top.singulars()
    np.testing.assert_array_equal(s.numpy(), np.repeat(top._singulars.numpy(), 3))
    img = np.random.default_rng(4).normal(size=(1, 1, RES, RES)).astype(np.float32)
    out = top.A(torch.as_tensor(np.repeat(img, 3, axis=1)).reshape(1, -1))
    out = out.reshape(1, 3, RES, RES).numpy()
    np.testing.assert_allclose(out[:, 1], out[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[:, 2], out[:, 0], rtol=0, atol=1e-6)


def test_per_row_inpainting_rows_equal_shared_operators():
    rows = T.Inpainting(3, RES, [_MISSING, _MISSING[:120]], device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 3 * RES * RES)),
                        dtype=torch.float32)
    for r, miss in enumerate((_MISSING, _MISSING[:120])):
        one = T.Inpainting(3, RES, miss, device="cpu")
        for f in ("V", "Vt", "A", "A_pinv", "A_with_zeros"):
            np.testing.assert_array_equal(getattr(rows, f)(x)[r].numpy(),
                                          getattr(one, f)(x[r:r + 1])[0].numpy(), err_msg=f)


def test_create_inpainting_operator_mask_semantics():
    opt = {"mask_type": "random", "mask_prob_range": (0.2, 0.4)}
    gens = [torch.Generator().manual_seed(s) for s in (7, 8)]
    op = T.create_inpainting_operator(3, RES, opt, generator=gens, repeats=2, device="cpu")
    sv = op.singulars().numpy()
    assert sv.shape == (4, 3 * RES * RES)
    np.testing.assert_array_equal(sv[0], sv[1])
    np.testing.assert_array_equal(sv[2], sv[3])
    assert not np.array_equal(sv[0], sv[2])
    missing = 1 - sv.mean(axis=1)
    assert ((missing >= 0.2 - 1e-9) & (missing <= 0.4)).all(), missing
    # the missing coordinates are the mask's zeros in its (C, H, W) flattening
    m = tmasks.generate_mask(torch.Generator().manual_seed(7), dict(opt, image_size=RES))[0]
    want = np.where(m.reshape(-1).numpy() == 0)[0]
    np.testing.assert_array_equal(np.sort(op._perm[0, sv[0] == 0].numpy()), want)
    shared = T.create_inpainting_operator(3, RES, opt, generator=torch.Generator().manual_seed(7),
                                          device="cpu")
    np.testing.assert_array_equal(shared._perm.numpy(), op._perm[0].numpy())
    assert shared.singulars().dim() == 1


def test_ddnm_factors_stay_finite_where_jax_overflows():
    """At 64 px Deblurring's unthresholded Kronecker singular values reach
    3.3e-21, whose 1 / s^2 overflows f32: the JAX package's d1 is NaN
    there (0 * -inf); the port's is finite and agrees with it elsewhere."""
    jop = J.Deblurring(_KERNEL, 3, 64)
    top = T.Deblurring(_KERNEL, 3, 64, device="cpu")
    args = (0.5, 0.1, 0.8, 1.0)
    with jax.enable_x64(False):
        want = J._ddnm_factors(jop._singulars_orig, jnp.float32(args[0]), args[1],
                               jnp.float32(args[2]), args[3])
    got = T._ddnm_factors(top._singulars_orig, np.float32(args[0]), args[1],
                          np.float32(args[2]), args[3])
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=1e-6, atol=0)
    assert not np.isfinite(np.asarray(want[1])).all()
