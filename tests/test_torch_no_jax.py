"""The port (``free_hunch_tpu_torch/`` and ``chip_smoke.py``) imports no
``jax``, no ``flax`` and nothing of the JAX package ``free_hunch_tpu``: every
file is parsed and every import statement, at any depth, is checked, as are
``importlib.import_module`` / ``__import__`` calls with a literal name."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "free_hunch_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "free_hunch_tpu")


def _forbidden(module: str) -> bool:
    """Exact match on the top-level package: ``free_hunch_tpu_torch`` is not
    ``free_hunch_tpu``."""
    return module.split(".")[0] in FORBIDDEN


def forbidden_imports(source: str, filename: str = "<src>"):
    """(line, module) of every forbidden import in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and _forbidden(node.args[0].value):
                found.append((node.lineno, node.args[0].value))
    return sorted(found)


def test_the_port_has_files_to_check():
    assert "free_hunch_tpu_torch/__init__.py" in PORT_FILES
    for module in ("operators/svd.py", "samplers/ddnm.py", "samplers/edm.py",
                   "models/precond.py"):
        assert f"free_hunch_tpu_torch/{module}" in PORT_FILES
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    src = (ROOT / path).read_text()
    assert forbidden_imports(src, path) == []


def test_the_check_sees_every_form_of_import():
    src = "\n".join([
        "import jax.numpy as jnp",
        "import os, flax",
        "from free_hunch_tpu.ops import dct",
        "import free_hunch_tpu",
        "def f():",
        "    from jax import lax",
        "    import importlib; importlib.import_module('free_hunch_tpu.models')",
        "    __import__('jax')",
        "import free_hunch_tpu_torch.ops",
        "from free_hunch_tpu_torch import resolve_device",
        "from . import lowrank",
        "import jaxlib_like_name_is_fine",
    ])
    assert [m for _, m in forbidden_imports(src)] == [
        "jax.numpy", "flax", "free_hunch_tpu.ops", "free_hunch_tpu", "jax",
        "free_hunch_tpu.models", "jax"]
