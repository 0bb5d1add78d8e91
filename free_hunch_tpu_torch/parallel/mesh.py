"""The mesh string of the JAX package and the cross-rank mean.

Counterpart of ``free_hunch_tpu/parallel/mesh.py``. There a mesh spans
the devices of one process ('data' shards a batch over them, 'model' the
UNet and covariance); here one process drives one card, so the data axis
is the process world (``torchrun --nproc_per_node=N``, the images strided
over ranks by ``data/dataset.py::shard_indices``) and a process's own
data axis is 1. ``make_mesh``, ``batch_sharding``, ``replicated`` and
``shard_batch`` place arrays on the devices of one process and have no
counterpart in a process-per-card design.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist

from free_hunch_tpu_torch.parallel.dist import get_world_size

#: what raises for a model axis above one
MODEL_AXIS = ("(ROADMAP item 15, the model axis: parallel/sharded_cov.py with "
              "FreeHunch.cov_partition and UNetConfig.spatial_partition)")


def parse_mesh_shape(mesh_shape: str, n_devices: Optional[int] = None) -> Dict[str, int]:
    """'data:-1' or 'data:4,model:2' -> {'data': N, 'model': 2}, -1 filled
    from ``n_devices`` (default 1: the card this process drives). Equal to
    the JAX package's function for the same ``n_devices``."""
    n = 1 if n_devices is None else n_devices
    axes: Dict[str, int] = {}
    for part in mesh_shape.split(","):
        name, _, size = part.strip().partition(":")
        axes[name] = int(size) if size else -1
    fixed = int(np.prod([v for v in axes.values() if v > 0])) if axes else 1
    for k, v in axes.items():
        if v == -1:
            axes[k] = max(n // max(fixed, 1), 1)
    return axes


def check_mesh_shape(mesh_shape: Optional[str]) -> Dict[str, int]:
    """The axes of ``mesh_shape`` for one process on one card; raises for a
    model axis above one (not ported) and for a data axis above one (a
    process drives one card: run more ranks instead)."""
    axes = parse_mesh_shape(mesh_shape or "data:-1")
    if axes.get("model", 1) > 1:
        raise NotImplementedError(f"mesh_shape={mesh_shape!r}: a model axis above one "
                                  f"{MODEL_AXIS}")
    if axes.get("data", 1) > 1:
        raise ValueError(f"mesh_shape={mesh_shape!r}: a data axis of {axes['data']} asks "
                         f"one process for {axes['data']} cards, but a process drives "
                         f"one; start {axes['data']} ranks (torchrun --nproc_per_node="
                         f"{axes['data']}) with mesh_shape=data:1")
    return axes


def all_reduce_mean(value) -> float:
    """The mean of every element of ``value`` over every rank: the mean of
    the global array the ranks hold parts of (each rank's elements weigh
    equally, whatever the size of its part)."""
    arr = np.asarray(value, np.float64)
    t = torch.tensor([arr.sum(), arr.size], dtype=torch.float64)
    if get_world_size() > 1:
        if tdist.get_backend() == "nccl":
            t = t.cuda()
        tdist.all_reduce(t)
    return float(t[0] / t[1])
