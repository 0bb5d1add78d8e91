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
