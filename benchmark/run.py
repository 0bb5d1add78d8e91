"""The benchmark of free_hunch_tpu_torch's guided sampler on one NVIDIA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``
(images whose sampling began in the window), ``failed`` (images of the
finished runs whose sample is not finite: the window's whole runs, and run
0 where the window closed inside it and it finished untimed), ``metrics``
(the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics),
``device`` and, last, ``check``: each number compared beside its limit,
which also close standard error. Exits non-zero with no result line where the card is
missing, where a module of JAX or of the JAX package is loaded at the end,
or where the run fails.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = CHECKOUT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "free_hunch_tpu")

# every cache of the program and its libraries at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(CHECKOUT)]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_facts() -> dict:
    """The card's name, power limit and clocks from nvidia-smi, or {}."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": q}


def metric_values(cell: dict, bench: dict, res: dict, traced: bool) -> dict:
    import spec
    if not traced:
        ctx = dict(images_per_min=res["images_per_min"],
                   peak_mem_gib=res["peak_bytes"] / 2 ** 30, setup_s=res["setup_s"])
        return {m["name"]: {"value": ctx[m["name"]], "unit": m["unit"]}
                for m in spec.end_to_end(cell["name"], bench)}
    out = {}
    ctx = dict(res, cell=cell)
    for m in spec.per_layer(cell["name"], bench):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell: dict, bench: dict, res: dict, traced: bool, kind: str, chips: int) -> dict:
    """The result line of a finished run: ``correct`` from the numbers
    and their limits, the metrics, the device and, last, the check."""
    import compare
    limits = cell["limits"]
    nums = res["numbers"]
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(res["peak_bytes"])}
    line = {"correct": bool(compare.verdict(nums, limits) and res["failed"] == 0),
            "attempted": res["runs_started"] * res["batch"], "failed": res["failed"],
            "metrics": metric_values(cell, bench, res, traced), "device": device}
    if traced:
        tr = res["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    line["check"] = {k: {"value": nums.get(k), "limit": limits[k]} for k in limits}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import harness
    import spec
    t_imports = time.time() - T_START
    bench = spec.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    smi = card_facts()
    print(json.dumps({"card": smi, "imports_s": t_imports, "card_facts_s": time.time() - T_START}),
          file=sys.stderr)
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START,
                           device="cuda", cache_dir=CACHE / "data")
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(cell, bench, res, bool(args.trace), torch.cuda.get_device_name(0),
                       entry["chips"])
    info = {k: res[k] for k in ("window_s", "setup_s", "calls", "runs_done", "cg_iters",
                                "host_syncs", "check_s", "capacity", "setup_phases",
                                "trace_read_s", "norm_bytes") if k in res}
    print(json.dumps({"run": info}), file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
