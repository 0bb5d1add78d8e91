"""The plain reference at a tiny size: against itself (blocks of rows,
dense algebra, its own CG) and against the program where both are
float32."""
import numpy as np
import pytest
import torch

from _tiny import ADM, TINY_MODEL, one_thread

import compare  # noqa: E402
import spec  # noqa: E402
import weights as weights_mod  # noqa: E402
from reference import freehunch as ref_fh  # noqa: E402


def tiny_arch():
    cfg = spec.config("imagenet256-adm")["model"]
    cfg.update(TINY_MODEL)
    return cfg, ADM.arch_of(cfg)


def test_blocks_of_rows_give_the_whole_batch():
    one_thread()
    cfg, arch = tiny_arch()
    p = weights_mod.float32(weights_mod.make(ADM.param_shapes(arch), 7, "cpu",
                                             {"torso": "float32"}))
    x = torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(0)) * 3
    ct = torch.randn_like(x)
    d1, (g1,) = compare.denoise_rows(ADM, p, arch, x, 3.0, 1, [(ct, x)])
    d4, (g4,) = compare.denoise_rows(ADM, p, arch, x, 3.0, 4, [(ct, x)])
    torch.testing.assert_close(d1, d4, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g1, g4, rtol=1e-5, atol=1e-6)
    dn, _ = compare.denoise_rows(ADM, p, arch, x, 3.0, 2)
    torch.testing.assert_close(dn, d4, rtol=1e-5, atol=1e-6)


def _cov(b=2, d=12, k=4, K=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    Ut = torch.zeros((b, K, d), dtype=torch.float64)
    Ut[:, :k] = torch.randn((b, k, d), generator=g, dtype=torch.float64)
    M = torch.eye(K, dtype=torch.float64).repeat(b, 1, 1)
    M[:, :k, :k] = torch.diag_embed(torch.rand((b, k), generator=g, dtype=torch.float64) * 0.3)
    diag = 0.5 + torch.rand((b, d), generator=g, dtype=torch.float64)
    return ref_fh.Cov(diag, Ut, M, torch.full((b,), k))


def dense(c):
    K = c.Ut.shape[1]
    act = (torch.arange(K)[None, :] < c.k[:, None]).double()
    U = c.Ut * act[:, :, None]
    return torch.diag_embed(c.diag) + U.transpose(1, 2) @ c.M @ U


def test_low_rank_algebra_against_dense_matrices():
    c = _cov()
    v = torch.randn(c.diag.shape, dtype=torch.float64)
    torch.testing.assert_close(ref_fh.matvec(c, v), (dense(c) @ v[..., None])[..., 0])
    torch.testing.assert_close(dense(ref_fh.inverse(c)), torch.linalg.inv(dense(c)))
    s0, s1 = 3.0, 2.0
    st = ref_fh.Before(c, s0, torch.zeros(2, 3, 2, 2, dtype=torch.float64),
                       torch.zeros(2, 3, 2, 2, dtype=torch.float64), None, 1)
    moved = ref_fh.cov_update(st, torch.zeros(2, 3, 2, 2, dtype=torch.float64),
                              torch.zeros(2, 3, 2, 2, dtype=torch.float64), s1,
                              ref_fh.Basis("identity"), window=(0.0, 0.0))[0]
    want = torch.linalg.inv(torch.linalg.inv(dense(c)) + (1 / s1 ** 2 - 1 / s0 ** 2) *
                            torch.eye(12, dtype=torch.float64))
    torch.testing.assert_close(dense(moved), want)
    a, b = torch.randn(2, 12, dtype=torch.float64), torch.randn(2, 12, dtype=torch.float64)
    added = ref_fh.append_pair(c, a, torch.tensor([0.3, -0.2], dtype=torch.float64), b,
                               torch.tensor([0.1, 0.2], dtype=torch.float64))
    want = dense(c)[0] + 0.3 * a[0, :, None] * a[0, None, :] + 0.1 * b[0, :, None] * b[0, None, :]
    torch.testing.assert_close(dense(added)[0], want)
    full = ref_fh.append_pair(added, a, torch.tensor([0.3, 0.3], dtype=torch.float64), b,
                              torch.tensor([0.1, 0.1], dtype=torch.float64))
    assert full.k.tolist() == [6, 6]
    again = ref_fh.append_pair(full, a, torch.tensor([0.3, 0.3], dtype=torch.float64), b,
                               torch.tensor([0.1, 0.1], dtype=torch.float64))
    assert again.k.max() <= 6


def test_the_secant_pair_meets_the_secant_equation():
    c = _cov()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 12), generator=g, dtype=torch.float64)
    xn = x + 0.1 * torch.randn((2, 12), generator=g, dtype=torch.float64)
    m, mn = 0.3 * x, 0.3 * xn + 0.05 * torch.randn((2, 12), generator=g, dtype=torch.float64)
    new, margin = ref_fh.space_update(c, 2.0, x, xn, m, mn)
    assert bool((margin > 0).all())
    de = 4.0 * (mn - m)
    torch.testing.assert_close(ref_fh.matvec(new, xn - x), de, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("prior,kind", [("dct_diagonal", "blur"), ("identity", "blur"),
                                        ("dct_diagonal", "mask")])
def test_cg_meets_its_tolerance(prior, kind):
    res = 16
    g = torch.Generator().manual_seed(1)
    basis = ref_fh.Basis(prior)
    c = _cov(b=2, d=3 * res * res, k=2, K=4)
    c = ref_fh.Cov(c.diag.float(), c.Ut.float() * 0.05, c.M.float(), c.k)
    if kind == "blur":
        op = ref_fh.Blur(np.load(spec.ROOT / "free_hunch_tpu/assets/kernels/gaussian_ks61_std3.0.npy"),
                         res, res, 0.1, "cpu")
    else:
        op = ref_fh.Mask((torch.rand((2, 3, res, res), generator=g) > 0.2).float(), 0.1)
    x0 = torch.rand((2, 3, res, res), generator=g) * 2 - 1
    y = op.forward(torch.rand((2, 3, res, res), generator=g) * 2 - 1)
    s = ref_fh.system(op, basis, c, x0, y)
    u, it = ref_fh.cg(s, s.b, 1e-4)
    assert it > 1
    rho = ref_fh.rel_residual(op, basis, c, x0, y, u)
    assert float(rho.max()) < 1e-3


def test_a_continuous_sigma_schedule_is_the_programs():
    """A denoiser with no sigma grid (the VE range of NCSN++, round_sigma
    the identity): the reference's Heun schedule equals the program's."""
    from free_hunch_tpu_torch.samplers import edm
    for steps in (8, 30):
        xs, s0 = edm.prepare_schedule(round_sigma=lambda s: np.asarray(s, np.float64),
                                      net_sigma_min=0.01, net_sigma_max=1348.0,
                                      num_steps=steps, solver="heun", discretization="edm",
                                      schedule="linear", scaling="none")
        mine = ref_fh.schedule(steps, None, (0.01, 1348.0))
        for k in ("sigma_hat", "h", "sigma_prime", "c1", "c2", "use_heun"):
            np.testing.assert_array_equal(mine[k], xs[k])
        assert mine["sigma0"] == s0 and ref_fh.cov_capacity(mine) == edm.required_cov_capacity(xs)


def test_the_schedule_and_the_denoiser_are_the_programs():
    """Where both run in float32 on the CPU: the Heun schedule equals the
    program's, and the UNet agrees with the program's float32 torso."""
    from free_hunch_tpu_torch.models import loading
    from free_hunch_tpu_torch.models.unet import create_model
    from free_hunch_tpu_torch.samplers import edm
    one_thread()
    cfg, arch = tiny_arch()
    w = weights_mod.make(ADM.param_shapes(arch), 5, "cpu", {"torso": "float32"})
    model = create_model(**cfg, dtype=torch.float32, remat=False)
    model.load_state_dict(w)
    pre = loading.wrap_precond(model.eval().requires_grad_(False), cfg)
    xs, s0 = edm.prepare_schedule(round_sigma=pre.round_sigma, net_sigma_min=pre.sigma_min,
                                  net_sigma_max=pre.sigma_max, num_steps=30, solver="heun",
                                  discretization="edm", schedule="linear", scaling="none")
    mine = ref_fh.schedule(30, ADM.snap_grid(arch), ADM.sigma_range(arch))
    for k in ("sigma_hat", "h", "sigma_prime", "c1", "c2"):
        np.testing.assert_array_equal(mine[k], xs[k])
    assert mine["sigma0"] == s0 and ref_fh.cov_capacity(mine) == edm.required_cov_capacity(xs)
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(2)) * 4
    with torch.no_grad():
        got, _ = pre(x, float(xs["sigma_hat"][10]))
    pre, _ = compare.denoise_rows(ADM, weights_mod.float32(w), arch, x,
                                  float(xs["sigma_hat"][10]), 2)
    torch.testing.assert_close(got, torch.clamp(pre, -1, 1), rtol=1e-4, atol=1e-5)
