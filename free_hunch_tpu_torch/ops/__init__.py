"""See the module docstrings; the layout mirrors free_hunch_tpu. The
package exports what ``free_hunch_tpu/ops/__init__.py`` exports, and
``fftn2``, ``ifftn2`` and ``data_solution`` beside them."""
from free_hunch_tpu_torch.ops.dct import dct_2d, idct_2d, dct_matrix  # noqa: F401
from free_hunch_tpu_torch.ops.fftops import (  # noqa: F401
    data_solution, downsample, fftn2, ifftn2, p2o, pre_calculate, splits, upsample,
)
from free_hunch_tpu_torch.ops.cg import cg_batch, cg_solve  # noqa: F401
