"""Runs the toy family's cell through a checkout's harness on the CPU and
prints one JSON line: the sound run's result line and numbers, and the
numbers with the planted fault (the toy program's output scaled by
1 + 1e-3).

    python drive.py <checkout> <image cache dir> <seed>
"""
import json
import sys
import time
from pathlib import Path

root, cache, seed = Path(sys.argv[1]), sys.argv[2], int(sys.argv[3])
sys.path[:0] = [str(root / "benchmark"), str(root)]

import torch  # noqa: E402

import harness  # noqa: E402
import run  # noqa: E402
import spec  # noqa: E402

torch.set_num_threads(2)


def toy_cell():
    c = spec.cell("toy32-blur-vjp")
    c["traffic"].update(batch=2, steps=8, trace={"first_call": 2, "calls": 3})
    return c


c = toy_cell()
res = harness.run_cell(c, seed, 2.0, True, time.time(), device="cpu", cache_dir=cache)
line = run.result_line(c, spec.benchmark(), res, True, "cpu", 1)
net = spec.program(c["config"]).Net
real = net.forward
net.forward = lambda self, x, c_noise: real(self, x, c_noise) * (1 + 1e-3)
c = toy_cell()
bad = harness.run_cell(c, seed, 0.0, False, time.time(), device="cpu", cache_dir=cache)
print(json.dumps({"line": line, "numbers": res["numbers"], "calls": res["calls"],
                  "norm_bytes": res["norm_bytes"], "fault": bad["numbers"],
                  "fault_correct": run.result_line(c, spec.benchmark(), bad, False, "cpu",
                                                   1)["correct"]}))
