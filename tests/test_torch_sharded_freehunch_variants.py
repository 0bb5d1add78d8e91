"""Free Hunch with the model axis in the port, as
``tests/test_torch_sharded_freehunch.py`` runs it (``data:1,model:2``, 3
Heun steps against the JAX package's unsharded ``sample_scan``, rtol 2e-3
and atol 2e-4, equal CG counts), with the float64 covariance algebra (the
suite's x64 on the JAX side) and with ``guidance_gradient='covariance'``."""
import pytest

from tests._torch_parity import one_thread  # noqa: F401
from tests.test_torch_sharded_freehunch import check_against_jax, setup, sharded_run  # noqa: F401


@pytest.mark.parametrize("name", ["f64", "covariance"])
def test_sharded_variant_equals_jax_sample_scan(setup, tmp_path, name):  # noqa: F811
    mesh_shape = "data:1,model:2"
    check_against_jax(setup, sharded_run(setup, tmp_path, name, mesh_shape), name, mesh_shape)
