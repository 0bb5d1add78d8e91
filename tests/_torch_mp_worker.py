"""One rank of a CPU gloo world for the port's multi-process tests (not a
pytest module). It imports the port only, never JAX.

    python tests/_torch_mp_worker.py <mode> <rank> <world> <store> <outdir> [<json>]

The ranks meet through a ``file://`` store at ``<store>``. ``mode``:

* ``collectives``: ``init`` (twice), rank and world, ``barrier``,
  ``CheckpointIO``, ``shard_indices``, the driver's ``_process_mean`` and
  ``_process_sum``, ``metrics/fid.py::allgather_merge``,
  ``parallel/mesh.py::all_reduce_mean`` and ``utils/stats.py`` with
  rank-divergent counter names; writes ``result_<rank>.json`` and the
  merged FID moments to ``fid_<rank>.npz``.
* ``eval``: the port's ``Evaluator`` (``DDNMEvaluator`` for
  ``conditioning_mechanism=ddnm``) on the CPU with the options in
  ``<json>``; writes the totals to ``worker_result_<rank>.json``.
"""
import json
import os
import sys

mode, rank, world, store, outdir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4], sys.argv[5])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from free_hunch_tpu_torch.parallel import dist  # noqa: E402


def join():
    for _ in range(2):  # idempotent: the command line joins, then the Evaluator
        dist.init(init_method=f"file://{store}", world_size=world, rank=rank, timeout=120)
    assert (dist.get_rank(), dist.get_world_size()) == (rank, world)


def collectives() -> dict:
    from free_hunch_tpu_torch import eval as teval
    from free_hunch_tpu_torch.data.dataset import shard_indices
    from free_hunch_tpu_torch.metrics.fid import FeatureStats, allgather_merge
    from free_hunch_tpu_torch.parallel.mesh import all_reduce_mean
    from free_hunch_tpu_torch.utils import stats

    join()
    dist.barrier()

    # CheckpointIO: rank 0 writes two bundles, every rank reads them
    class Box:
        def __init__(self, v):
            self.v = v

        def state_dict(self):
            return {"v": self.v}

        def load_state_dict(self, sd):
            self.v = sd["v"]

    ckpt_dir = os.path.join(outdir, "ckpt")
    for step in (1, 2):
        dist.CheckpointIO(box=Box(10 * step + rank), step=step).save(
            os.path.join(ckpt_dir, f"state-{step:04d}.pkl"), verbose=False)
    box = Box(None)
    io = dist.CheckpointIO(box=box)
    loaded = io.load(os.path.join(ckpt_dir, "state-0001.pkl"), verbose=False)
    first = (box.v, loaded["step"])
    latest = io.load_latest(ckpt_dir, verbose=False)
    ckpt = dict(first=first, latest=os.path.basename(latest), latest_box=box.v,
                none=dist.CheckpointIO(box=box).load_latest(os.path.join(outdir, "nothing")))

    # unequal shards: rank 0 holds 3 samples at 1.0, rank 1 one at 5.0 ->
    # the sample-weighted mean 2.0 (the mean of the rank means would be 3.0)
    n_samples = 3 if rank == 0 else 1
    means = dict(psnr=1.0 if rank == 0 else 5.0, ssim=0.5 if rank == 0 else 0.9,
                 lpips=0.2 if rank == 0 else 0.6)
    reduced = teval._process_mean(means, n_samples)
    summed = teval._process_sum(n_samples)

    # FID moments: disjoint features per rank, merged bit-exactly
    rng = np.random.default_rng(0)  # the same stream on every rank
    all_feats = [rng.normal(1e3, 1.0, (3, 16)) for _ in range(world)]
    mine = FeatureStats(16)
    mine.add(all_feats[rank])
    merged = allgather_merge(mine)
    want = FeatureStats(16)
    for f in all_feats:
        want.add(f)
    np.savez(os.path.join(outdir, f"fid_{rank}.npz"), n=merged.n, s=merged.s, ss=merged.ss)
    fid_exact = (merged.n == want.n and np.array_equal(merged.s, want.s)
                 and np.array_equal(merged.ss, want.ss))

    # stats with rank-divergent names: 'shared' on every rank (rank sums 2
    # and 4 over 2 samples each), 'head' on rank 0 only
    stats.init_multiprocessing(rank=rank)
    stats.report("shared", [float(rank) + 1.0] * 2)
    stats.report0("head", 7.0)
    collector = stats.Collector()
    collector.update()
    first_window = dict(shared_num=collector.num("shared"),
                        shared_mean=collector.mean("shared"),
                        head_num=collector.num("head"), head_mean=collector.mean("head"))
    collector.update()  # no new data: the previous window stays
    second_window = dict(shared_num=collector.num("shared"),
                         shared_mean=collector.mean("shared"),
                         head_num=collector.num("head"), head_mean=collector.mean("head"))

    mean_all = all_reduce_mean(np.arange(rank + 2, dtype=np.float64))
    dist.barrier()
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                indices=shard_indices(10, world, rank).tolist(), reduced=reduced,
                summed=summed, fid_merge_exact=bool(fid_exact), ckpt=ckpt,
                stats_first=first_window, stats_second=second_window,
                all_reduce_mean=mean_all)


def evaluate() -> dict:
    from free_hunch_tpu_torch import config as tcfg
    from free_hunch_tpu_torch.eval import Evaluator
    from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator

    join()
    opts = tcfg.load_config(args=json.loads(sys.argv[6]))
    cls = DDNMEvaluator if opts.get("conditioning_mechanism") == "ddnm" else Evaluator
    results = cls(opts, device="cpu").run()
    return {k: v for k, v in results.items()
            if isinstance(v, (int, float, str, bool, type(None)))}


try:
    result = {"collectives": collectives, "eval": evaluate}[mode]()
    name = "result" if mode == "collectives" else "worker_result"
    with open(os.path.join(outdir, f"{name}_{rank}.json"), "w") as f:
        json.dump(result, f)
finally:
    dist.destroy()
print(f"rank {rank} done", flush=True)
