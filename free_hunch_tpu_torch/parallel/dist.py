"""Multi-process runtime over ``torch.distributed``: the rendezvous, rank
and world helpers, the preemption sentinels, ``CheckpointIO`` and exact
cross-rank gathers.

Counterpart of ``free_hunch_tpu/parallel/dist.py``. One process drives one
card: ``torchrun --nproc_per_node=N`` (``python -m torch.distributed.run``)
starts the ranks and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, which ``init``
reads where its arguments do not say otherwise (the JAX package reads
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_INDEX``). Without a process group the program is a world of
one. Rank ``r`` runs on ``local_device(LOCAL_RANK, device_count)``.

The backend is ``nccl`` where every rank of this host has a card of its own
and ``gloo`` otherwise (the CPU, or several ranks on one card, which NCCL
does not support). Gather payloads sit on the CPU under gloo and on the
rank's card under nccl.
"""
from __future__ import annotations

import datetime
import glob
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as tdist

from free_hunch_tpu_torch import resolve_device


def local_device(local_rank: int, device_count: int) -> torch.device:
    """The card of the rank with ``local_rank`` on a host of
    ``device_count`` cards: one card per rank, round robin where the host
    has fewer cards than ranks."""
    if device_count < 1:
        raise ValueError("local_device: the host has no CUDA card")
    return torch.device(f"cuda:{int(local_rank) % int(device_count)}")


def default_backend(local_world: int, cards: int) -> str:
    """``nccl`` where each of this host's ``local_world`` ranks has a card
    of its own, else ``gloo`` (the CPU, or ranks sharing a card, which NCCL
    does not support)."""
    return "nccl" if 0 < local_world <= cards else "gloo"


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def init(backend: Optional[str] = None, init_method: Optional[str] = None,
         world_size: Optional[int] = None, rank: Optional[int] = None,
         timeout: Optional[float] = None) -> None:
    """Join the process group if this is a world of more than one;
    nothing otherwise. Idempotent: the command line joins before its first
    rank query, then the Evaluator calls ``init()`` again.

    Explicit arguments win; the rest come from torchrun's environment.
    ``backend`` defaults to ``default_backend`` for this host;
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``);
    ``timeout`` is in seconds (torch's default when None)."""
    if tdist.is_initialized():
        return
    world = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return
    rank = rank if rank is not None else _env_int("RANK", None)
    if rank is None:
        raise ValueError("init: a world of more than one needs the rank (RANK)")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = backend or default_backend(local_world, cards)
    if cards:
        torch.cuda.set_device(local_device(local_rank, cards))
    kw = {} if timeout is None else dict(timeout=datetime.timedelta(seconds=float(timeout)))
    tdist.init_process_group(backend, init_method=init_method or "env://",
                             world_size=world, rank=rank, **kw)
    if rank == 0:
        print(f"free_hunch_tpu_torch: process group of {world} ranks on {backend} "
              f"({local_world} on this host, {cards} card(s))", flush=True)


def destroy() -> None:
    """Leave the process group (every rank, at the end of a run)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def get_rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def get_world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def get_local_rank() -> int:
    """The rank among this host's ranks: ``LOCAL_RANK`` where torchrun set
    it, else the rank."""
    return _env_int("LOCAL_RANK", get_rank()) if tdist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The device a rank computes on: ``device`` where given, else its own
    card (``local_device``), which raises where there is none."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return local_device(get_local_rank(), torch.cuda.device_count())


def print0(*args, **kwargs) -> None:
    if get_rank() == 0:
        print(*args, **kwargs)


def barrier() -> None:
    if get_world_size() > 1:
        tdist.barrier()


def should_stop() -> bool:
    """Preemption hook: true once the file ``FREE_HUNCH_STOP_FILE`` names
    exists."""
    sentinel = os.environ.get("FREE_HUNCH_STOP_FILE")
    return bool(sentinel and os.path.exists(sentinel))


def should_suspend() -> bool:
    sentinel = os.environ.get("FREE_HUNCH_SUSPEND_FILE")
    return bool(sentinel and os.path.exists(sentinel))


def _payload_device() -> torch.device:
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(value) -> np.ndarray:
    """Every rank's ``value`` (an array of the same shape and dtype on every
    rank), stacked in rank order on a new first axis. float64 and int64
    travel as they are: ``all_gather`` moves the tensor's bytes, so no
    rounding happens (the JAX package ships f64 as int32 words because its
    gather canonicalises f64 to f32 when x64 is off)."""
    arr = np.ascontiguousarray(value)
    if get_world_size() <= 1:
        return arr[None].copy()
    t = torch.from_numpy(arr).to(_payload_device())
    parts = [torch.empty_like(t) for _ in range(get_world_size())]
    tdist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if get_world_size() <= 1:
        return [obj]
    out = [None] * get_world_size()
    tdist.all_gather_object(out, obj)
    return out


class CheckpointIO:
    """Save, load and ``load_latest`` of named state bundles: rank 0 writes,
    a barrier, then any rank reads. An object with ``state_dict`` /
    ``load_state_dict`` is saved and restored through them; any other is
    stored as it is. Files are pickles this program wrote."""

    def __init__(self, **objects: Any):
        self._objects = dict(objects)

    def save(self, path: str, verbose: bool = True) -> None:
        if get_rank() == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            state = {name: obj.state_dict() if hasattr(obj, "state_dict") else obj
                     for name, obj in self._objects.items()}
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(state, f)
            os.replace(tmp, path)
            if verbose:
                print0(f"saved checkpoint {path}")
        barrier()

    def load(self, path: str, verbose: bool = True) -> dict:
        with open(path, "rb") as f:
            state = pickle.load(f)
        for name, obj in self._objects.items():
            if name in state and hasattr(obj, "load_state_dict"):
                obj.load_state_dict(state[name])
        if verbose:
            print0(f"loaded checkpoint {path}")
        return state

    def load_latest(self, run_dir: str, pattern: str = "*.pkl",
                    verbose: bool = True) -> Optional[str]:
        files = sorted(glob.glob(os.path.join(run_dir, pattern)))
        if not files:
            return None
        self.load(files[-1], verbose=verbose)
        return files[-1]
