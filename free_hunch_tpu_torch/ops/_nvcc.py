"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, bound with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, where the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source or header rebuilds and a stale library is never loaded.
Builds happen at first use, never at import; ``build_all`` starts one
``nvcc`` per source together, so the sources build in about the time of the
slowest one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def sources() -> List[str]:
    """The kernel sources, by name (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns (process, temporary output, library, start time) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> dict:
    proc, tmp, out, t0 = started
    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{report}")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "ptxas": report}


def build_all(names: Optional[List[str]] = None) -> Dict[str, Optional[dict]]:
    """Compile the named sources (default: every ``csrc/*.cu``), one
    ``nvcc`` each, all started together. Returns {name: {"seconds": wall
    time of that build, "ptxas": compiler report}, or None where the library
    already existed}. Waits for every build, then raises with the compiler
    output of the first that failed."""
    names = sources() if names is None else list(names)
    started = {n: _start(n) for n in names}
    reports, failure = {}, None
    for n in names:
        if started[n] is None:
            reports[n] = None
            continue
        try:
            reports[n] = _finish(n, started[n])
        except RuntimeError as e:
            failure = failure or e
    if failure is not None:
        raise failure
    return reports


def build(name: str) -> Optional[dict]:
    """Compile ``csrc/<name>.cu`` unless its library exists (see
    ``build_all``)."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
