"""A denoiser family is files: a copy of ``benchmark/`` takes a toy
family that is not ADM and has no sigma grid (``toy_family/``: a
reference module, a program module whose norm goes through the port's
``groupnorm_silu`` under a continuous-sigma VE preconditioner, a
configuration and a cell on ``blur-vjp``) as new files alone; no file the
copy started with changes; the harness's run of the cell at 32 px (two
images, eight Heun steps) reads correct, and with the toy program's output
scaled by 1 + 1e-3 it reads not correct."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from _tiny import BENCH

ROOT = BENCH.parent
TOY = BENCH / "tests" / "toy_family"
SEED = 2 ** 31 + 1717


def digests(base):
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def checkout(tmp_path):
    """A checkout with a copy of ``benchmark/``, the toy family's files
    added to it, and BENCHMARK.json with the toy's configuration and cell;
    the program, the images and the assets linked from the repository."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("free_hunch_tpu_torch", "free_hunch_tpu", "data"):
        os.symlink(ROOT / name, root / name)
    before = digests(root / "benchmark")
    added = []
    for sub in ("reference", "program", "configs", "workloads"):
        for f in sorted((TOY / sub).iterdir()):
            dest = root / "benchmark" / sub / f.name
            assert not dest.exists(), dest
            shutil.copy(f, dest)
            added.append(str(dest.relative_to(root / "benchmark")))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy32-ve", "source": "a toy for the benchmark's tests",
                             "file": "benchmark/configs/toy32-ve.json", "reduced": [],
                             "why": "a continuous-sigma VE denoiser that is not ADM"})
    bench["workloads"].append({"name": "toy32-blur-vjp", "config": "toy32-ve",
                               "traffic": "blur-vjp", "chips": 1, "why": "the toy's cell"})
    for m in bench["per_layer"]:
        m["workloads"].append("toy32-blur-vjp")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before, added


def test_a_family_added_as_files_runs_and_its_fault_is_caught(tmp_path):
    root, before, added = checkout(tmp_path)
    p = subprocess.run([sys.executable, str(TOY / "drive.py"), str(root),
                        str(ROOT / ".bench_cache" / "data"), str(SEED)],
                       capture_output=True, text=True, timeout=900,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    after = digests(root / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(added)
    line = out["line"]
    assert line["correct"] and line["failed"] == 0, out["numbers"]
    assert out["calls"] > 0 and line["metrics"]["mfu"]["value"] > 0
    assert out["norm_bytes"]["k1_calls"] > 0 and out["norm_bytes"]["bwd_calls"] > 0
    assert not out["fault_correct"], out["fault"]
