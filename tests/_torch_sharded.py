"""Helpers of the port's model-axis tests (tests/test_torch_sharded_*.py):
a CPU gloo world of ``tests/_torch_mp_sharded_worker.py`` ranks, each
bounded by a timeout after which every rank is killed (a hang guard: a
rank stuck in a collective whose peer died never returns by itself)."""
import os
import subprocess
import sys
import uuid

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mp_sharded_worker.py")
WAIT_S = 180


def run_world(mode: str, world: int, mesh_shape: str, inputs: dict, tmp,
              timeout: float = WAIT_S) -> list:
    """Every rank's output dict of ``mode`` on ``inputs`` in a world of
    ``world`` ranks split by ``mesh_shape``; raises with the ranks' output
    when one fails or the world outlives ``timeout`` seconds."""
    d = tmp / f"{mode}_{uuid.uuid4().hex[:8]}"
    d.mkdir()
    torch.save(inputs, d / "inputs.pt")
    store = d / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(world), str(store),
                               str(d), mesh_shape], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    wait_all(procs, f"{mode} world of {world} ({mesh_shape})", timeout)
    return [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(world)]


def wait_all(procs, label: str, timeout: float = WAIT_S, ok: bool = True) -> list:
    """Each rank's output; every rank killed if the world outlives
    ``timeout`` seconds. ``ok``: assert that every rank exited 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{label} hung past {timeout} s")
    if ok:
        for rank, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"{label} rank {rank} failed:\n{out[-3000:]}"
    return outs
