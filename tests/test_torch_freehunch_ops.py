"""Port parity for Free Hunch on super-resolution (x4) and inpainting (one
explicit mask), and for ``use_analytic_var_at_end`` on every solver family:
the comparisons of tests/test_torch_freehunch.py, with its helpers, on the
other operators.

* Teacher-forced per call over the same sigma sequence (time updates, the
  BFGS window, low sigma), x0 to rtol 1e-4 / atol 5e-4, equal CG niter.
* use_analytic_var_at_end across mle_sigma_thres = 0.2: above it the
  covariance solve, below it the recon_mse variance on the scipy budget
  (the CPU's 'auto' coordinates, as in the JAX package), with the vjp and
  with the covariance gradient (var * mat / sigma^2 there).

The 3-step Heun slices on these operators are in
tests/test_torch_freehunch_ops_slice.py (each file stays under a minute).
"""
import pytest

from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_freehunch import _teacher_forced, prior_dir  # noqa: F401

OPS = ["super_resolution", "inpainting"]
# Inpainting takes the flat prior: under the 32 px DCT prior its solve (no
# spectral preconditioner, a mask against 8 decades of variance) stops by
# stall far from rtol, and a 1e-7 relative change of x_t alone moves the
# JAX package's x0 by 2.7 and its CG count by up to 5 (28-33 at sigma 40):
# no two f32 paths can agree there. Super-resolution keeps the DCT prior.
PRIOR = {"super_resolution": {}, "inpainting": {"image_base_covariance": "dct_diagonal_noinfo"}}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("grad,warm,fb_threshold", [("vjp", "prev", 1e9),
                                                    ("covariance", "b", 0.2)])
def test_x0_mean_update_teacher_forced_matches_jax(op, grad, warm, fb_threshold, prior_dir):
    _teacher_forced(prior_dir, op=op, guidance_gradient=grad, cg_warm_start=warm,
                    guidance_vjp_below=2.0, denoiser_mean_error_threshold=fb_threshold,
                    **PRIOR[op])


@pytest.mark.parametrize("op", ["gaussian_blur"] + OPS)
@pytest.mark.parametrize("grad", ["vjp", "covariance"])
def test_analytic_var_at_end_matches_jax(op, grad, prior_dir):
    _teacher_forced(prior_dir, op=op, sigmas=[6.0, 0.4, 0.15, 0.15, 0.05], full_rank=False,
                    use_analytic_var_at_end=True, guidance_gradient=grad,
                    cg_warm_start="prev", denoiser_mean_error_threshold=1e9,
                    **PRIOR.get(op, {}))
