"""Where the benchmark's data lives, found by name.

* ``BENCHMARK.json`` at the root of the checkout: the cells and metrics.
* ``benchmark/workloads/<cell>.json``: a cell's configuration and traffic
  names, its correctness limits and what its check samples.
* ``benchmark/configs/<config>.json``: a configuration's published shapes,
  its prior, its precision and the program's model options (``program``:
  ``create_model``'s remat, quant, ...).
* ``benchmark/traffic/<traffic>.json``: a traffic mix's parameters, read by
  the one generator in ``inputs.py`` and ``harness.py``.
* ``benchmark/reference/operators/<operator>.py``: the measurement operator
  a traffic mix names, on both sides: the reference's and the keyword
  arguments of the program's.
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(ctx)`` returning a number, or None where the run gave it
  nothing to read.

A later cell, configuration, traffic mix or metric is a new file and a new
entry; no file here needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_MODULES: dict = {}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def cell(name: str, base: Path = HERE) -> dict:
    """A cell with its configuration and traffic merged in:
    {"name", "config": {...}, "traffic": {...}, "limits": {...}, ...}."""
    c = _json(base / "workloads" / f"{name}.json")
    c = dict(c, name=name)
    c["config"] = _json(base / "configs" / f"{c['config']}.json")
    c["traffic"] = _json(base / "traffic" / f"{c['traffic']}.json")
    return c


def per_layer(cell_name: str, bench: dict) -> List[dict]:
    """The per-layer metrics this cell reports: those listing it, and
    those without a ``workloads`` key."""
    return [m for m in bench.get("per_layer", [])
            if "workloads" not in m or cell_name in m["workloads"]]


def end_to_end(cell_name: str, bench: dict) -> List[dict]:
    return [m for m in bench.get("end_to_end", [])
            if "workloads" not in m or cell_name in m["workloads"]]


def _module(path: Path, key: str):
    """The module of a file, loaded once a process."""
    path = path.resolve()
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            key.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module(base / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read


def operator(name: str, base: Path = HERE):
    """The module of ``reference/operators/<name>.py``: its ``make(op,
    batch, res, gen, device)`` gives the reference operator of one run
    (``reference/freehunch.py::Blur``'s interface) with ``program``, the
    keyword arguments the program's ``get_operator(name, in_shape=...,
    sigma_s=..., device=...)`` takes besides; ``gen(purpose)`` is a
    generator of the run for what the operator draws."""
    return _module(base / "reference" / "operators" / f"{name}.py", f"benchmark_operator_{name}")


def names(kind: str, base: Path = HERE) -> Dict[str, Path]:
    """Every file of ``kind`` (configs, traffic, workloads, metrics) by name."""
    suffix = ".py" if kind == "metrics" else ".json"
    return {p.name[:-len(suffix)]: p for p in sorted((base / kind).glob(f"*{suffix}"))
            if not p.name.startswith("_")}
