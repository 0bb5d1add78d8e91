"""Port parity for K2's plain version, ``ops/gn_quant.py::gn_silu_quant_plain``
(GroupNorm + per-sample affine + SiLU + per-sample int8 quantise), against
the JAX package's twin ``gn_silu_quant_reference`` and against its Pallas
kernels ``_pallas_gn_silu_quant`` run in interpret mode on the CPU.

Tolerances: the scales to 1e-6 relative (one f32 abs-max over the same
formula, other summation orders for the statistics). The codes equal, except
where y / s lies within rounding of a half-integer: there they may differ by
one, on at most 1e-3 of the codes (at these sizes that allows a handful).
Where a group's |mean| is far above its std, f32 rounding of x - mean is
amplified by |mean| / std in both packages, and the scale tolerance grows
to 2 f32 epsilons times that ratio. Observed on the CPU: every code equal,
scales within 1.3e-7 relative, against the twin and the Pallas kernels."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops import pallas_gn_quant as jgq
from free_hunch_tpu_torch.ops import gn_quant as tgq

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _inputs(shape, seed, offset=0.5, spread=2.0):
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]
    x = (rng.normal(size=shape) * spread + offset).astype(np.float32)
    g = (rng.normal(size=(n, c)) * 0.2 + 1).astype(np.float32)
    b = (rng.normal(size=(n, c)) * 0.2).astype(np.float32)
    return x, g, b


def _port(x, g, b, dtype):
    xq, s = tgq.gn_silu_quant(torch.as_tensor(x).to(dtype), torch.as_tensor(g),
                              torch.as_tensor(b), 32, 1e-5)
    assert xq.dtype == torch.int8 and s.dtype == torch.float32
    return xq.numpy(), s.numpy()


def _check(got, want, ratio=0.0, max_frac=1e-3):
    (tq, ts), (jq, js) = got, want
    jq, js = np.asarray(jq), np.asarray(js)
    assert tq.shape == jq.shape and ts.shape == js.shape == (tq.shape[0], 1, 1, 1)
    rel = np.abs(ts - js) / js
    assert rel.max() <= max(1e-6, 2 * 2.0 ** -23 * ratio), (rel.max(), ratio)
    d = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= max_frac, (d.max(), (d > 0).mean())
    return d


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 4, 16, 128), (3, 5, 7, 256)])
def test_plain_matches_jax_twin(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, g, b = _inputs(shape, seed=sum(shape))
    want = jax.jit(jgq.gn_silu_quant_reference, static_argnums=(3, 4))(
        jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(b), 32, 1e-5)
    _check(_port(x, g, b, tdt), want)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_plain_matches_jax_twin_when_mean_dominates(dtype):
    """|mean| / std = 150 in every group: a centred variance in both."""
    jdt, tdt = DTYPES[dtype]
    x, g, b = _inputs((2, 8, 8, 128), seed=5, offset=300.0)
    xj = jnp.asarray(x).astype(jdt)
    want = jax.jit(jgq.gn_silu_quant_reference, static_argnums=(3, 4))(
        xj, jnp.asarray(g), jnp.asarray(b), 32, 1e-5)
    xf = np.asarray(xj.astype(jnp.float32))
    _check(_port(x, g, b, tdt), want, ratio=float(np.abs(xf.mean()) / xf.std()))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """``pallas_gn_quant.py`` looks ``pallas_call`` up through ``pl`` at call
    time, so the real TPU kernels run in Pallas' interpret mode on the CPU."""
    orig = jgq.pl.pallas_call
    monkeypatch.setattr(jgq.pl, "pallas_call", functools.partial(orig, interpret=True))


@pytest.mark.parametrize("dtype,shape", [("bf16", (2, 8, 8, 128)), ("f32", (2, 4, 8, 256))])
def test_plain_matches_pallas_kernels_in_interpret_mode(interpret_pallas, dtype, shape):
    """The Pallas kernels take E[x^2] - E[x]^2 and multiply by 1/s where the
    port divides by s: both can move a code at a tie."""
    jdt, tdt = DTYPES[dtype]
    x, g, b = _inputs(shape, seed=11)
    want = jgq._pallas_gn_silu_quant(jnp.asarray(x).astype(jdt), jnp.asarray(g),
                                     jnp.asarray(b), 32, 1e-5)
    # the twin and the kernels agree with each other the same way
    twin = jgq.gn_silu_quant_reference(jnp.asarray(x).astype(jdt), jnp.asarray(g),
                                       jnp.asarray(b), 32, 1e-5)
    _check((np.asarray(want[0]), np.asarray(want[1])), twin)
    _check(_port(x, g, b, tdt), want)


def test_plain_is_per_sample_and_exact_on_its_own_grid():
    """Each sample's codes reach +-127 at its own abs-max, and dequantised
    codes are within half a step of the f32 activation."""
    from free_hunch_tpu_torch.ops.quant import _gn_silu_ref_f32
    x, g, b = _inputs((3, 4, 4, 64), seed=3)
    x[1] *= 10.0
    xt, gt, bt = torch.as_tensor(x), torch.as_tensor(g), torch.as_tensor(b)
    xq, s = tgq.gn_silu_quant_plain(xt, gt, bt, 32, 1e-5)
    y = _gn_silu_ref_f32(xt, gt, bt, 32, 1e-5)
    assert torch.all(xq.reshape(3, -1).abs().amax(dim=1) == 127)
    assert float((xq.float() * s - y).abs().max()) <= float(s.max()) * (0.5 + 1e-5)


def test_wrapper_raises_off_cpu_and_cuda():
    x, g, b = _inputs((1, 2, 2, 32), seed=0)
    with pytest.raises(ValueError, match="unsupported device"):
        tgq.gn_silu_quant(torch.as_tensor(x, device="meta"), torch.as_tensor(g),
                          torch.as_tensor(b))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgq.gn_silu_quant_cuda(torch.as_tensor(x), torch.as_tensor(g), torch.as_tensor(b))


def _extremes_and_stats(x, groups, chunks, eps=1e-5):
    """Per-(sample, chunk, channel) min and max of x, chunks of whole rows
    as K2's statistics pass cuts them, and the group statistics by the
    plain version's formula."""
    n, h, w, c = x.shape
    xf = x.float()
    rows = -(-h * w // chunks)
    flat = xf.reshape(n, h * w, c)
    lo = torch.stack([flat[:, r:r + rows].amin(dim=1) for r in range(0, h * w, rows)], 1)
    hi = torch.stack([flat[:, r:r + rows].amax(dim=1) for r in range(0, h * w, rows)], 1)
    cg = c // groups
    mean = xf.mean(dim=(1, 2)).reshape(n, groups, cg).mean(dim=-1)
    centered = xf - mean.repeat_interleave(cg, dim=-1)[:, None, None, :]
    var = centered.square().mean(dim=(1, 2)).reshape(n, groups, cg).mean(dim=-1)
    return lo, hi, mean, torch.rsqrt(var + eps)


@pytest.mark.parametrize("case", ["random_bf16", "random_f32", "negative_gamma",
                                  "constant_channels", "negative_lobe"])
def test_scale_from_extremes_matches_the_plain_scale(case):
    """K2's finalize in PyTorch (``gn_silu_quant_scale_plain``): from the
    chunks' extremes of x, the scale equals the plain version's to 1e-6
    relative wherever the sample is not flagged, and a sample is flagged
    exactly where its abs-max lies below ``LOBE`` (inside the SiLU's
    negative lobe, where only a pass over every element finds it)."""
    x, g, b = _inputs((4, 8, 6, 128), seed=21)
    dtype = torch.float32 if case == "random_f32" else torch.bfloat16
    if case == "negative_gamma":
        g[1] = -np.abs(g[1])
        g[2, ::3] *= -1
    if case == "constant_channels":
        x[:, :, :, ::5] = 1.5
        x[2, :, :, :64] = -0.25
    if case == "negative_lobe":
        # samples 0 and 3: every t negative, the abs-max on the lobe
        for i in (0, 3):
            g[i] *= 0.2
            b[i] = b[i] * 0.1 - 1.28
    xt, gt, bt = torch.as_tensor(x).to(dtype), torch.as_tensor(g), torch.as_tensor(b)
    _, want = tgq.gn_silu_quant_plain(xt, gt, bt, 32, 1e-5)
    lo, hi, mean, rstd = _extremes_and_stats(xt, 32, chunks=5)
    scale, flag = tgq.gn_silu_quant_scale_plain(lo, hi, mean, rstd, gt, bt)
    assert scale.shape == want.shape and flag.dtype == torch.bool
    amax = want.flatten() * 127.0
    assert torch.equal(flag, amax < tgq.LOBE * (1 - 1e-6))
    if case == "negative_lobe":
        assert flag.tolist() == [True, False, False, True]
    else:
        assert not flag.any()
    ok = ~flag
    torch.testing.assert_close(scale.flatten()[ok], want.flatten()[ok], rtol=1e-6, atol=0)
    # a flagged sample's candidate never exceeds its true abs-max
    assert torch.all(scale.flatten()[flag] <= want.flatten()[flag] * (1 + 1e-6))
