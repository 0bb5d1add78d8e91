"""Port parity for the int8 layers, ``ops/quant.py`` against
``free_hunch_tpu/ops/quant.py``: the quantisers, ``int8_conv`` and
``int8_dense`` (dynamic and static, forward and pullback), the int8 product
(K3's plain version) and ``gn_quant_conv``. The accuracy, adjoint and
zero-gradient checks mirror ``tests/test_quant.py:31-93``.

Given the same int8 operands the int32 sums are exactly equal. With f32
inputs both packages quantise to the same codes (the same f32 arithmetic),
so the f32 outputs and pullbacks are bitwise equal too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.ops import quant as jq
from free_hunch_tpu_torch.ops import quant as tq

F32 = np.float32


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(F32)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- quantisers ---------------------------------------------------------------

@pytest.mark.parametrize("dims,shape", [((0, 1, 2), (3, 3, 16, 24)), ((0,), (32, 48))])
def test_quantize_weight_equals_jax(dims, shape):
    w = _normal(_rng(0), shape, 0.05)
    w[..., 3] = 0.0                     # an all-zero channel takes the 1e-12 floor
    jw, js = jq._quantize_weight(jnp.asarray(w), dims)
    tw, ts = tq._quantize_weight(_t(w), dims)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_act_equals_jax(dtype):
    """f32 bitwise. bf16: the codes of x * inv rounded once in bf16 (the
    port) or kept in f32 (XLA's CPU fusion may skip the intermediate bf16
    rounding) differ only where the product lands within a bf16 rounding of
    a half-integer: at most one code step, on at most 1 % of the codes."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = _normal(_rng(1), (3, 6, 5, 32), 2.0)
    x[1] *= 30.0
    xj = jnp.asarray(x).astype(jdt)
    jx, js = jax.jit(jq._quantize_act)(xj)
    tx, ts = tq._quantize_act(_t(x).to(tdt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    d = np.abs(tx.numpy().astype(np.int32) - np.asarray(jx).astype(np.int32))
    if dtype == "f32":
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, ((d > 0).mean())
    s = np.asarray(2.5 / 127, F32)
    np.testing.assert_array_equal(
        tq._quantize_act_static(_t(x), _t(s)).numpy(),
        np.asarray(jq._quantize_act_static(jnp.asarray(x), jnp.asarray(s))))


# -- the int8 product (K3's plain version) ------------------------------------

@pytest.mark.parametrize("k,pad", [(3, 1), (1, 0), (3, 2)])
def test_int8_sums_exactly_equal_jax(k, pad):
    rng = _rng(2)
    xq = rng.integers(-127, 128, size=(2, 7, 9, 32)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, k, 32, 48)).astype(np.int8)   # HWIO
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (1, 1), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    wk = _t(wq).permute(3, 0, 1, 2).contiguous()
    got = tq.int8_conv_plain(_t(xq), wk, None, None, pad, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    asc, wsc = _normal(rng, (2,), 0.01) + 0.02, _normal(rng, (48,), 0.01) + 0.02
    out = tq.int8_conv_plain(_t(xq), wk, _t(asc), _t(wsc), pad, torch.float32)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(want).astype(F32) * (asc[:, None, None, None] * wsc))


# -- int8_conv / int8_dense, dynamic and static, against JAX -------------------

def _pull(f_j, f_t, x, g, *extra):
    """Forward and pullback of one function in both packages."""
    out_j, vjp = jax.vjp(f_j, jnp.asarray(x), *[jnp.asarray(e) for e in extra])
    grads_j = vjp(jnp.asarray(g))
    xs = [_t(x).requires_grad_(True)] + [_t(e).requires_grad_(True) for e in extra]
    out_t = f_t(*xs)
    grads_t = torch.autograd.grad(out_t, xs, _t(g))
    return (np.asarray(out_j), [np.asarray(a) for a in grads_j],
            out_t.detach().numpy(), [a.numpy() for a in grads_t])


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k", [3, 1])
def test_int8_conv_forward_and_pullback_equal_jax(k, static):
    rng = _rng(3)
    x = _normal(rng, (2, 8, 8, 32))
    w = _normal(rng, (k, k, 32, 48), 0.05)
    g = _normal(rng, (2, 8, 8, 48))
    pad = k // 2
    if static:
        s = np.asarray(np.abs(x).max() / 127 * 1.1, F32)
        oj, gj, ot, gt = _pull(lambda a, ww, ss: jq.int8_conv_static(a, ww, ss, pad),
                               lambda a, ww, ss: tq.int8_conv_static(a, ww, ss, pad),
                               x, g, w, s)
        assert float(np.abs(gt[2])) == 0.0 and float(np.abs(gj[2])) == 0.0
    else:
        oj, gj, ot, gt = _pull(lambda a, ww: jq.int8_conv(a, ww, pad),
                               lambda a, ww: tq.int8_conv(a, ww, pad), x, g, w)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(gt[0], gj[0])
    assert gt[1].shape == w.shape and not gt[1].any() and not np.asarray(gj[1]).any()


@pytest.mark.parametrize("static", [False, True])
def test_int8_dense_forward_and_pullback_equal_jax(static):
    rng = _rng(4)
    x = _normal(rng, (2, 64, 96))
    w = _normal(rng, (96, 128))
    g = _normal(rng, (2, 64, 128))
    if static:
        s = np.asarray(np.abs(x).max() / 127, F32)
        oj, gj, ot, gt = _pull(jq.int8_dense_static, tq.int8_dense_static, x, g, w, s)
        assert float(np.abs(gt[2])) == 0.0
    else:
        oj, gj, ot, gt = _pull(jq.int8_dense, tq.int8_dense, x, g, w)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(gt[0], gj[0])
    assert not gt[1].any()


# -- accuracy against f32, the adjoint identity (tests/test_quant.py) ----------

def _f32_conv(x, w, pad):
    return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                      padding=pad).permute(0, 2, 3, 1)


class TestInt8ConvAccuracy:
    def setup_method(self, _):
        rng = _rng(0)
        self.x = _t(_normal(rng, (2, 16, 16, 32)))
        self.w = _t(_normal(rng, (3, 3, 32, 48), 0.05))
        self.g = _t(_normal(rng, (2, 16, 16, 48)))

    def test_forward_accuracy(self):
        # ~0.5% per-operand quantisation noise -> sub-1% output error
        assert rel_err(tq.int8_conv(self.x, self.w, 1), _f32_conv(self.x, self.w, 1)) < 0.015

    def test_pullback_accuracy(self):
        x = self.x.clone().requires_grad_(True)
        (dq,) = torch.autograd.grad(tq.int8_conv(x, self.w, 1), x, self.g)
        (df,) = torch.autograd.grad(_f32_conv(x, self.w, 1), x, self.g)
        assert rel_err(dq, df) < 0.015

    def test_pullback_is_adjoint_of_quantized_forward(self):
        """<A_q x, g> == <x, A_q^T g> up to the cotangent's own
        quantisation noise, normalised by ||A_q x|| ||g||."""
        x = self.x.clone().requires_grad_(True)
        out = tq.int8_conv(x, self.w, 1)
        (dx,) = torch.autograd.grad(out, x, self.g)
        lhs = float((out.detach() * self.g).sum())
        rhs = float((self.x * dx).sum())
        assert abs(lhs - rhs) / float(out.detach().norm() * self.g.norm()) < 0.01

    def test_weight_grad_is_zero(self):
        w = self.w.clone().requires_grad_(True)
        (dw,) = torch.autograd.grad(tq.int8_conv(self.x, w, 1), w, torch.ones_like(self.g))
        assert float(dw.abs().max()) == 0.0

    def test_1x1_conv(self):
        w1 = _t(_normal(_rng(4), (1, 1, 32, 48), 0.1))
        assert rel_err(tq.int8_conv(self.x, w1, 0), _f32_conv(self.x, w1, 0)) < 0.015

    def test_dense_forward_and_pullback(self):
        rng = _rng(1)
        x = _t(_normal(rng, (2, 64, 96))).requires_grad_(True)
        w = _t(_normal(rng, (96, 128)))
        g = _t(_normal(rng, (2, 64, 128)))
        (dq,) = torch.autograd.grad(tq.int8_dense(x, w), x, g)
        (df,) = torch.autograd.grad(x @ w, x, g)
        assert rel_err(tq.int8_dense(x, w).detach(), (x @ w).detach()) < 0.015
        assert rel_err(dq, df) < 0.015


# -- gn_quant_conv against JAX's custom_vjp -----------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gn_quant_conv_forward_and_pullback_match_jax(dtype):
    """Forward: K2's codes equal (tests/test_torch_gn_quant.py), then the
    same int8 product and epilogue, so equal outputs; allowed: one code step
    at a tie, 2e-3 of the output's scale. Backward: the cotangent quantises
    to the same codes and the int8 transposed product is exact, then
    autograd of the f32 GroupNorm+affine+SiLU in two frameworks: f32
    summation orders, 1e-4 of each gradient's scale (in bf16, x's gradient
    rounds to bf16 at the end: 1e-2)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = _rng(5)
    x = _normal(rng, (2, 8, 8, 64), 2.0) + 0.5
    gm = _normal(rng, (2, 64), 0.2) + 1
    bt = _normal(rng, (2, 64), 0.2)
    w = _normal(rng, (3, 3, 64, 32), 0.05)
    g = _normal(rng, (2, 8, 8, 32))
    xj = jnp.asarray(x).astype(jdt)
    out_j, vjp = jax.vjp(lambda a, b_, c_: jq.gn_quant_conv(a, b_, c_, jnp.asarray(w), 1, 32,
                                                            1e-5),
                         xj, jnp.asarray(gm), jnp.asarray(bt))
    dj = vjp(jnp.asarray(g).astype(jdt))
    ins = [torch.as_tensor(np.array(xj.astype(jnp.float32))).to(tdt).requires_grad_(True),
           _t(gm).requires_grad_(True), _t(bt).requires_grad_(True)]
    out_t = tq.gn_quant_conv(ins[0], ins[1], ins[2], _t(w), 1, 32, 1e-5)
    dt = torch.autograd.grad(out_t, ins, _t(g).to(tdt))
    assert out_t.dtype == tdt and dt[0].dtype == tdt
    oj = np.asarray(out_j.astype(jnp.float32))
    np.testing.assert_allclose(out_t.detach().float().numpy(), oj, rtol=0,
                               atol=2e-3 * np.abs(oj).max())
    for name, a, b_ in zip(("dx", "dgamma", "dbeta"), dt, dj):
        want = np.asarray(b_.astype(jnp.float32))
        tol = 1e-2 if (name == "dx" and dtype == "bf16") else 1e-4
        np.testing.assert_allclose(a.float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=name)
