"""GroupNorm(32)(+SiLU): the port's plain version against the JAX package's
``_reference`` and its Pallas kernel (interpret mode), gradients against
``jax.grad``, and the kernel wrapper's launch plan and input checks. The
Hopper kernel itself is held against the plain version on the card in
``tests/test_torch_cuda_kernels.py``."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops import pallas_groupnorm as pg
from free_hunch_tpu_torch.ops import groupnorm as gn

F32 = np.float32


def _case(seed, shape=(2, 8, 4, 128), mean=0.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) + mean).astype(F32)
    gamma = (rng.normal(size=(c,)) * 0.1 + 1).astype(F32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(F32)
    return x, gamma, beta


@pytest.mark.parametrize("shape", [(2, 8, 4, 128), (2, 5, 3, 32), (1, 4, 4, 96),
                                   (3, 2, 2, 2048)])
@pytest.mark.parametrize("silu", [True, False])
def test_plain_matches_jax_reference(shape, silu):
    """Same f32 formula in both: rtol=atol=1e-5 covers reduction order."""
    x, g, b = _case(0, shape)
    want = np.asarray(pg._reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                    32, 1e-5, silu))
    got = gn.groupnorm_silu_plain(torch.as_tensor(x), torch.as_tensor(g),
                                  torch.as_tensor(b), 32, 1e-5, silu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_bf16_matches_jax_reference_within_one_ulp():
    x, g, b = _case(1, (2, 8, 8, 64))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pg._reference(xj, jnp.asarray(g), jnp.asarray(b), 32, 1e-5, True),
                      F32)
    xt = torch.as_tensor(np.asarray(xj, F32)).to(torch.bfloat16)
    got = gn.groupnorm_silu(xt, torch.as_tensor(g), torch.as_tensor(b)).float().numpy()
    # both compute in f32 and round once to bf16: at most one bf16 ulp apart
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


def test_plain_matches_pallas_kernel_interpret_mode():
    """The TPU kernel itself, run in interpret mode as
    tests/test_pallas_groupnorm.py runs it."""
    from jax.experimental import pallas as pl
    n, h, w, c, groups = 2, 8, 4, 128, 32
    x, g, b = _case(2, (n, h, w, c))
    th = 4
    stats = pl.pallas_call(
        partial(pg._stats_kernel, groups=groups), grid=(n, h // th),
        in_specs=[pl.BlockSpec((1, th, w, c), lambda i, j: (i, j, 0, 0))],
        out_specs=pl.BlockSpec((1, 2, groups), lambda i, j: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, 2, groups), jnp.float32), interpret=True,
    )(jnp.asarray(x))
    y = pl.pallas_call(
        partial(pg._apply_kernel, groups=groups, eps=1e-5, count=float(h * w * c // groups),
                apply_silu=True), grid=(n, h // th),
        in_specs=[pl.BlockSpec((1, th, w, c), lambda i, j: (i, j, 0, 0)),
                  pl.BlockSpec((1, 2, groups), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((c,), lambda i, j: (0,)),
                  pl.BlockSpec((c,), lambda i, j: (0,))],
        out_specs=pl.BlockSpec((1, th, w, c), lambda i, j: (i, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True,
    )(jnp.asarray(x), stats, jnp.asarray(g), jnp.asarray(b))
    got = gn.groupnorm_silu_plain(torch.as_tensor(x), torch.as_tensor(g),
                                  torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("silu", [True, False])
def test_gradients_match_jax_grad(silu):
    x, g, b = _case(3, (2, 4, 4, 64))

    def loss(a, gg, bb):
        return jnp.sum(pg._reference(a, gg, bb, 32, 1e-5, silu) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (x, g, b)]
    (gn.groupnorm_silu(*ts, 32, 1e-5, silu) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_autograd_function_backward_is_plain_autograd(monkeypatch):
    """The kernel's autograd.Function: backward recomputes the plain version
    (the JAX custom_vjp). On the CPU the forward is swapped for the plain
    version, so the backward code itself runs here."""
    monkeypatch.setattr(gn, "groupnorm_silu_cuda", gn.groupnorm_silu_plain)
    x, g, b = _case(4, (2, 4, 4, 64))
    for need in ((True, False, False), (True, True, True), (False, True, False)):
        a = [torch.as_tensor(v).requires_grad_(r) for v, r in zip((x, g, b), need)]
        ref = [torch.as_tensor(v).requires_grad_(r) for v, r in zip((x, g, b), need)]
        ct = torch.as_tensor(np.random.default_rng(5).normal(size=x.shape).astype(F32))
        y = gn._GroupNormSiLU.apply(*a, 32, 1e-5, True)
        y_ref = gn.groupnorm_silu_plain(*ref, 32, 1e-5, True)
        got = torch.autograd.grad(y, [t for t in a if t.requires_grad], ct)
        want = torch.autograd.grad(y_ref, [t for t in ref if t.requires_grad], ct)
        for u, v in zip(got, want):
            torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_centred_variance_survives_a_large_mean():
    """|mean| >> std: E[x^2] - E[x]^2 in f32 loses every digit here; the
    centred variance keeps the result within f32 rounding of an f64 oracle."""
    x, g, b = _case(6, (1, 16, 16, 64), mean=3000.0)
    x64 = x.astype(np.float64).reshape(1, -1, 32, 2)
    mu = x64.mean(axis=(1, 3), keepdims=True)
    var = ((x64 - mu) ** 2).mean(axis=(1, 3), keepdims=True)
    want = ((x64 - mu) / np.sqrt(var + 1e-5)).reshape(x.shape) * g + b
    got = gn.groupnorm_silu_plain(torch.as_tensor(x), torch.as_tensor(g),
                                  torch.as_tensor(b), apply_silu=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n,s,c,vec", [(2, 65536, 256, 8), (8, 65536, 512, 8),
                                       (2, 64, 1024, 8), (2, 65536, 256, 4),
                                       (3, 35, 64, 8), (1, 1, 2048, 8)])
def test_kernel_plan_covers_every_row(n, s, c, vec):
    plan = gn.gn_plan(n, s, c, 32, 16 // vec, 132)
    ty, rows, p = plan.ty, plan.rows, plan.chunks
    assert (c // vec) * ty <= 1024 and ty >= 1 and rows >= 1
    assert rows >= ty or plan.path == "cluster"
    assert (p - 1) * rows < s <= p * rows


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_silu_cuda(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="unsupported device"):
        gn.groupnorm_silu(x.to("meta"), torch.ones(64), torch.zeros(64))
