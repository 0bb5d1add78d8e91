"""Where the benchmark's data lives, found by name.

* ``BENCHMARK.json`` at the root of the checkout: the cells and metrics.
* ``benchmark/workloads/<cell>.json``: a cell's configuration and traffic
  names, its correctness limits and what its check samples.
* ``benchmark/configs/<config>.json``: a configuration's published shapes
  (``model``), its prior, its precision, the program's model options
  (``program``: remat, quant, ...) and, under ``family``, its denoiser
  family (``adm`` where the key is absent).
* ``benchmark/reference/<family>.py``: a denoiser family's plain float32
  reference, which imports nothing of the program: ``arch_of``,
  ``param_shapes`` (each parameter's name, shape and init kind),
  ``preclamp`` (the denoiser before its clip, with the control's
  ``rounding`` hook), ``snap_grid`` (the sigmas the denoiser snaps to, or
  None) and ``sigma_range``, and the frozen counts ``forward_flops``,
  ``input_backward_flops`` and ``norm_inputs``.
* ``benchmark/program/<family>.py``: the family on the program's side, the
  only files here that import the program's model code: ``build`` (the
  model from the configuration with the weights loaded, and its
  preconditioner, whose ``round_sigma``, ``sigma_min`` and ``sigma_max``
  set the sampler's schedule) and ``norm_modules`` (the modules whose
  inputs the traced stretch counts GroupNorm bytes of).
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
import sys
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


def family(config: dict) -> str:
    """A configuration's denoiser family: its ``family`` key, else "adm"."""
    return config.get("family", "adm")


def reference(config: dict, base: Path = HERE):
    """The module of ``reference/<family>.py`` of ``config``'s family."""
    name = family(config)
    return _module(base / "reference" / f"{name}.py", f"benchmark_reference_{name}")


def program(config: dict, base: Path = HERE):
    """The module of ``program/<family>.py`` of ``config``'s family."""
    name = family(config)
    return _module(base / "program" / f"{name}.py", f"benchmark_program_{name}")


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
        sys.modules[spec.name] = mod     # a dataclass looks its module up while it is made
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
