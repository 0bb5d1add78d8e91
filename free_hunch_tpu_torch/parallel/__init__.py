from free_hunch_tpu_torch.parallel.dist import init as dist_init  # noqa: F401
from free_hunch_tpu_torch.parallel.dist import (  # noqa: F401
    barrier, get_rank, get_world_size, print0,
)
