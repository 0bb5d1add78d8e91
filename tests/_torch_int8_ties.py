"""Where the unsharded int8 port's codes part from the JAX package's.

Runs the 32 px int8 UNet of tests/_torch_parity.py in both packages on the
same input, records every site's activation codes (``_quantize_act`` of
the dynamic torso, ``_quantize_act_static`` of the calibrated one) in call
order, and compares them site by site. A differing code is "at a tie" when
the two packages' scaled values (x / scale) lie within 1e-3 of each other:
then the code moved because float rounding carried the value across a
half-integer, not because the layer computes something else. The first
site with a differing code shows where a difference starts; every later
site inherits it (a flipped code moves its product by one quantisation
step, and the per-sample abs-max with it).

    JAX_PLATFORMS=cpu python -m tests._torch_int8_ties   # 5 seeds x 3 noise levels

prints one JSON line per input and torso. tests/test_torch_int8_ties.py
holds two of them."""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from free_hunch_tpu.models.precond import IDDPMLinearPrecond as JPrecond
from free_hunch_tpu.ops import quant as jq
from free_hunch_tpu_torch.models import loading as tload
from free_hunch_tpu_torch.models.convert import qscales_to_flax
from free_hunch_tpu_torch.models.precond import IDDPMLinearPrecond as TPrecond
from free_hunch_tpu_torch.ops import quant as tq
from tests._torch_parity import RES, quant_pair

F32 = np.float32
TIE = 1e-3      # the largest |x_jax / s - x_port / s| a rounding difference gives
SEEDS = (11, 12, 13, 14, 15)
SIGMAS = (0.7, 5.0, 50.0)


@contextlib.contextmanager
def recording(static: bool):
    """Both packages' activation quantisers record (scaled value, codes) in
    call order into the yielded dict's "jax" and "port" lists."""
    rec = {"jax": [], "port": []}
    name = "_quantize_act_static" if static else "_quantize_act"
    jfn, tfn = getattr(jq, name), getattr(tq, name)

    def jrec(x, *a):
        # called once per site while jit traces, in call order; the values
        # arrive through a callback when the compiled function runs
        out = jfn(x, *a)
        xq, s = (out, a[0]) if static else out
        inv = (jnp.float32(1.0) / s).astype(x.dtype)
        rec["jax"].append(None)
        jax.debug.callback(lambda v, q, i=len(rec["jax"]) - 1: rec["jax"].__setitem__(
            i, (np.asarray(v, np.float64), np.asarray(q))), x * inv, xq)
        return out

    def trec(x, *a):
        out = tfn(x, *a)
        xq, s = (out, a[0]) if static else out
        inv = (1.0 / s).to(x.dtype)
        rec["port"].append(((x * inv).double().numpy(), xq.numpy()))
        return out

    setattr(jq, name, jrec)
    setattr(tq, name, trec)
    try:
        yield rec
    finally:
        setattr(jq, name, jfn)
        setattr(tq, name, tfn)


def _jax_layout(a: np.ndarray, like: np.ndarray) -> np.ndarray:
    """A port site's array in the JAX package's layout (NHWC convs, (n, t, c)
    dense layers)."""
    if a.shape == like.shape:
        return a
    if like.ndim == 3:
        return a.reshape(like.shape)
    return a.transpose(0, 2, 3, 1)


def site_readings(rec: dict) -> list:
    """Per site: codes that differ, those at a tie, those away from one."""
    assert len(rec["jax"]) == len(rec["port"]), (len(rec["jax"]), len(rec["port"]))
    rows = []
    for (xs_j, q_j), (xs_t, q_t) in zip(rec["jax"], rec["port"]):
        xs_t, q_t = _jax_layout(xs_t, xs_j), _jax_layout(q_t, q_j)
        diff = q_j != q_t
        tie = diff & (np.abs(xs_j - xs_t) < TIE)
        rows.append(dict(codes=int(q_j.size), differ=int(diff.sum()), at_tie=int(tie.sum()),
                         away=int((diff & ~tie).sum())))
    return rows


def summary(rows: list) -> dict:
    first = next((i for i, r in enumerate(rows) if r["differ"]), None)
    return dict(sites=len(rows), first_site=first,
                first=None if first is None else rows[first],
                differ=sum(r["differ"] for r in rows),
                codes=sum(r["codes"] for r in rows),
                sites_that_differ=sum(1 for r in rows if r["differ"]))


def _inputs(seed: int, sigma: float) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(2, 3, RES, RES)) * sigma).astype(F32)


def dynamic_case(seed: int, sigma: float, models=None) -> dict:
    """The dynamic int8 torso's denoiser at ``sigma`` on one seeded input."""
    jm, params, tm = models or quant_pair("int8")
    jp = JPrecond(jm, img_resolution=RES, img_channels=3)
    tp = TPrecond(tm, img_resolution=RES, img_channels=3)
    return _case(jp, params, tp, seed, sigma, static=False)


def static_models():
    """The int8_static pair and the calibration table of
    tests/test_torch_unet_int8.py (three stages, margin 1.1)."""
    from tests.test_torch_unet_int8 import _table
    jm, params, tm = quant_pair("int8_static")
    qs = _table(tm.cfg, TPrecond(torch.nn.Identity(), img_resolution=RES, img_channels=3))
    jsig, jtree = qscales_to_flax(qs, tm.cfg)
    jp = JPrecond(jm, img_resolution=RES, img_channels=3,
                  qscales=(jsig, jax.tree.map(jnp.asarray, jtree)))
    return jp, params, tload.wrap_precond(tm, {"image_size": RES}, qscales=qs)


def static_case(seed: int, sigma: float, models=None) -> dict:
    jp, params, tp = models or static_models()
    return _case(jp, params, tp, seed, sigma, static=True)


def _case(jp, params, tp, seed, sigma, static) -> dict:
    x = _inputs(seed, sigma)
    s = float(F32(sigma))
    with recording(static) as rec:
        jd = np.asarray(jax.jit(jp.apply)(params, jnp.asarray(x),
                                          jnp.asarray(s, jnp.float32))[0])
        with torch.no_grad():
            td = tp(torch.as_tensor(x), s)[0].numpy()
    return dict(seed=seed, sigma=sigma, torso="int8_static" if static else "int8",
                denoiser_max_abs=float(np.abs(jd - td).max()), **summary(site_readings(rec)))


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    dyn, sta = quant_pair("int8"), static_models()
    for seed in SEEDS:
        for sigma in SIGMAS:
            print(json.dumps(dynamic_case(seed, sigma, dyn)), flush=True)
            print(json.dumps(static_case(seed, sigma, sta)), flush=True)
