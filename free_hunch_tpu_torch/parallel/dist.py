"""Process rank and world size over ``torch.distributed``: the part of
``free_hunch_tpu/parallel/dist.py`` the evaluation driver calls.

Without an initialised process group the program is a world of one. The
rendezvous itself (``init`` joining a group), ``CheckpointIO`` and the
multi-process driver wait for ROADMAP item 15; the port reads no
environment, so a caller that initialises a process group gives it its
address, world size and rank.
"""
from __future__ import annotations

import torch.distributed as tdist


def init() -> None:
    """Join the distributed runtime: nothing to do for a world of one, the
    only world the port's driver runs in yet."""


def get_rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def get_world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def print0(*args, **kwargs) -> None:
    if get_rank() == 0:
        print(*args, **kwargs)


def barrier() -> None:
    if get_world_size() > 1:
        tdist.barrier()
