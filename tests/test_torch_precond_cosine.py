"""Port parity for the cosine iDDPM preconditioner (``IDDPMCosinePrecond``,
``_cosine_sigma_grid``) against the JAX package's
``free_hunch_tpu/models/precond.py:36-45, :162-217``, its route through
``wrap_precond(kind='cosine')`` and a ``precond_kind='cosine'``
calibration. It differs from the linear class in three places: c_noise is
M - 1 - idx, sigma_min is u[M - 1] of its own grid, and x0_var is the MLE
variance sigma^2 / (1 + sigma^2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.models import precond as jpre
from free_hunch_tpu_torch.models import calibrate as tcal
from free_hunch_tpu_torch.models import loading as tload
from free_hunch_tpu_torch.models import precond as tpre
from free_hunch_tpu_torch.samplers import edm as tedm
from tests._torch_parity import RES, one_thread, quant_pair, tiny_pair  # noqa: F401

F32 = np.float32


@pytest.mark.parametrize("C_1,C_2,M", [(0.001, 0.008, 1000), (0.001, 0.008, 250),
                                       (0.01, 0.02, 100)])
def test_cosine_sigma_grid_equals_jax(C_1, C_2, M):
    got, want = tpre._cosine_sigma_grid(C_1, C_2, M), jpre._cosine_sigma_grid(C_1, C_2, M)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 0.0 and np.all(np.diff(got) <= 0)


def _pair(kind="cosine"):
    jm, params, tm = tiny_pair()
    jcls = {"cosine": jpre.IDDPMCosinePrecond, "linear": jpre.IDDPMLinearPrecond}[kind]
    return (jcls(jm, img_resolution=RES, img_channels=3), params,
            tpre.PRECONDS[kind](tm, img_resolution=RES, img_channels=3))


def test_grid_and_round_sigma_equal_jax():
    jp, _, tp = _pair()
    assert tp.sigma_min == jp.sigma_min and tp.sigma_max == jp.sigma_max
    assert tp.sigma_min == float(tpre._cosine_sigma_grid(0.001, 0.008, 1000)[999])
    np.testing.assert_array_equal(tp.u_np, jp.u)
    # the grid's last entry is 0: sigma 0 snaps to it, index M
    s = np.asarray([0.0, 1e-4, jp.sigma_min, 0.01, 0.5, 1.0, 3.3, 17.0, 80.0, 200.0], F32)
    np.testing.assert_array_equal(tp.round_sigma(s), jp.round_sigma(s))
    np.testing.assert_array_equal(tp.round_sigma(s, return_index=True),
                                  jp.round_sigma(s, return_index=True))
    assert int(tp.round_sigma(np.float32(0.0), return_index=True)) == tp.M
    np.testing.assert_array_equal(tp.round_sigma(torch.as_tensor(s)).numpy(),
                                  np.asarray(jp.round_sigma(jnp.asarray(s))))
    np.testing.assert_array_equal(tp.round_sigma(torch.as_tensor(s), return_index=True).numpy(),
                                  np.asarray(jp.round_sigma(jnp.asarray(s), return_index=True)))


class _RecordT(torch.nn.Module):
    """Stand-in network that records its timestep argument."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x, t, y=None):
        self.seen.append(t)
        return torch.zeros(x.shape[0], 6, *x.shape[2:])


@pytest.mark.parametrize("kind,offset", [("cosine", 1), ("linear", 0)])
def test_c_noise_equals_jax(kind, offset):
    """c_noise = M - 1 - idx on the cosine grid, M - idx on the linear one."""
    jp, _, _ = _pair(kind)
    rec = _RecordT()
    tp = tpre.PRECONDS[kind](rec, img_resolution=RES, img_channels=3)
    seen = []

    class JRecord:
        def apply(self, variables, x, t, y=None):
            seen.append(np.asarray(t))
            return jnp.zeros((x.shape[0], 6) + x.shape[2:])
    jp = type(jp)(JRecord(), img_resolution=RES, img_channels=3)
    x = np.zeros((2, 3, RES, RES), F32)
    for sigma in (0.05, 0.7, 12.0, 79.0):
        tp(torch.as_tensor(x), sigma)
        jp.apply({}, jnp.asarray(x), jnp.float32(sigma))
        idx = tp.round_sigma(np.float32(sigma), return_index=True)
        np.testing.assert_array_equal(rec.seen[-1].numpy(), seen[-1])
        assert float(rec.seen[-1][0]) == tp.M - offset - int(idx)


def test_denoiser_matches_jax_on_the_tiny_unet():
    """D_x within 2e-5 absolute (observed 1.5e-6; f32 UNets in two
    packages), x0_var equal to the MLE variance bit for bit."""
    jp, params, tp = _pair()
    rng = np.random.default_rng(3)
    for sigma in (0.03, 0.6, 5.0, 40.0):
        x = (rng.normal(size=(2, 3, RES, RES)) * sigma).astype(F32)
        jd, jv = jax.jit(jp.apply)(params, jnp.asarray(x), jnp.float32(sigma))
        td, tv = tp(torch.as_tensor(x), sigma)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-5)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv, F32))
        s = F32(sigma)
        np.testing.assert_array_equal(tv.numpy(), np.full(x.shape, s * s / (1 + s * s), F32))
    # a tensor sigma per row takes the same path as a host float
    sig = torch.full((2,), 5.0)
    np.testing.assert_array_equal(tp(torch.as_tensor(x), sig)[0].numpy(),
                                  tp(torch.as_tensor(x), 5.0)[0].numpy())


def test_wrap_precond_takes_both_kinds():
    _, _, tm = tiny_pair()
    args = {"image_size": RES}
    pc = tload.wrap_precond(tm, args, "cosine")
    pl = tload.wrap_precond(tm, args)
    assert isinstance(pc, tpre.IDDPMCosinePrecond) and isinstance(pl, tpre.IDDPMLinearPrecond)
    assert pc.sigma_min != pl.sigma_min and pc.img_resolution == RES and pc.label_dim == 0
    assert tload.wrap_precond(tm, dict(args, class_cond=True), "cosine").label_dim == 1000
    with pytest.raises(ValueError, match="unknown preconditioner"):
        tload.wrap_precond(tm, args, "sqrt")


def test_cosine_schedule_equals_jax():
    jp, _, tp = _pair()
    from free_hunch_tpu.samplers import edm as jedm
    for kw in (dict(num_steps=18), dict(num_steps=5, discretization="iddpm")):
        xj, sj = jedm.prepare_schedule(round_sigma=jp.round_sigma, net_sigma_min=jp.sigma_min,
                                       net_sigma_max=jp.sigma_max, **kw)
        xt, st = tedm.prepare_schedule(round_sigma=tp.round_sigma, net_sigma_min=tp.sigma_min,
                                       net_sigma_max=tp.sigma_max, **kw)
        assert sj == st
        for k in xj:
            np.testing.assert_array_equal(xt[k], xj[k])


def test_cosine_calibration_has_its_own_cache_key(tmp_path, monkeypatch):
    """``bench_qscales(precond_kind='cosine')`` calibrates on the cosine
    schedule (its stage sigmas are that grid's) and caches under a key the
    linear table does not share."""
    from tests.test_torch_unet_int8 import TINY_ARGS
    _, _, tm = quant_pair("int8")
    ck = str(tmp_path / "ck.pt")
    kw = dict(num_steps=3, res=RES, batch=2, dtype=torch.float32, n_draws=1, device="cpu")
    sig, table = tcal.bench_qscales(ck, TINY_ARGS, tm.state_dict(), precond_kind="cosine", **kw)
    pre = tpre.IDDPMCosinePrecond(torch.nn.Identity(), img_resolution=RES, img_channels=3)
    xs, _ = tedm.prepare_schedule(round_sigma=pre.round_sigma, net_sigma_min=pre.sigma_min,
                                  net_sigma_max=pre.sigma_max, num_steps=3)
    want = sorted({float(F32(s)) for s, _, _ in tcal.calibration_stages(xs)})
    np.testing.assert_array_equal(sig, np.asarray(want, F32))
    assert table and all(np.all(np.isfinite(v)) and np.all(v > 0) for v in table.values())
    assert len(list(tmp_path.glob("ck.pt.qscales.*.npz"))) == 1

    def refuse(*a, **k):
        raise AssertionError("calibrated")
    monkeypatch.setattr(tcal, "calibrate_qscales", refuse)
    tcal.bench_qscales(ck, TINY_ARGS, tm.state_dict(), precond_kind="cosine", **kw)
    with pytest.raises(AssertionError, match="calibrated"):
        tcal.bench_qscales(ck, TINY_ARGS, tm.state_dict(), precond_kind="linear", **kw)
