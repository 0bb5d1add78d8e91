from free_hunch_tpu_torch.parallel.dist import (  # noqa: F401
    barrier, get_rank, get_world_size, print0,
)
from free_hunch_tpu_torch.parallel.mesh import all_reduce_mean  # noqa: F401
