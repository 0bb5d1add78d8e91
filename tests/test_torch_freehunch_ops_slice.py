"""Free Hunch over 3 Heun steps at 32 px through the tiny UNet (same
weights) against the JAX package's ``sample_scan``, on super-resolution x4
and on inpainting with one explicit mask: the gaussian-blur slice test of
tests/test_torch_freehunch.py on the other operators, with the priors of
tests/test_torch_freehunch_ops.py."""
import numpy as np
import pytest

from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_freehunch import _run_slice, prior_dir  # noqa: F401
from tests.test_torch_freehunch_ops import OPS, PRIOR


@pytest.mark.parametrize("op", OPS)
def test_sampler_slice_three_heun_steps_matches_sample_scan(op, prior_dir):
    """As the gaussian-blur slice test: steps 0 and 1 within 3e-4 of their
    own max |x|, the last (the clipped denoiser's output) within 3e-4 of
    its input's, equal CG niter at every stage."""
    jtraj, ttraj, scale = _run_slice(prior_dir, "heun", op=op, **PRIOR[op])
    for i, lim in enumerate([3e-4 * scale[0], 3e-4 * scale[1], 3e-4 * scale[1]]):
        np.testing.assert_allclose(ttraj[i], jtraj[i], rtol=0, atol=lim,
                                   err_msg=f"step {i}")
