"""No module of the benchmark imports JAX or the JAX package, compared by
the whole top-level name (the port's own name, free_hunch_tpu_torch,
begins with the JAX package's); the reference imports nothing of the
program; only a family's program module (``program/<family>.py``) imports
the program's model code, and the ADM names live in the adm family's two
modules."""
import ast

from _tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "free_hunch_tpu"}


def imported(path):
    """Top-level names of every module a file imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def imported_modules(path):
    """Dotted names of every module a file imports, and of each name it
    imports from one (``from a.b import c``: a.b and a.b.c)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def harness_files():
    """The benchmark's files outside its tests."""
    return [f for f in sorted(BENCH.rglob("*.py")) if "tests" not in f.relative_to(BENCH).parts]


def test_only_program_modules_import_the_programs_models():
    models = "free_hunch_tpu_torch.models"
    users = {f.relative_to(BENCH).parts[0] for f in harness_files()
             if any(n == models or n.startswith(models + ".") for n in imported_modules(f))}
    assert users == {"program"}
    assert "free_hunch_tpu_torch.models.unet" in imported_modules(BENCH / "program" / "adm.py")


def test_the_adm_names_live_in_the_adm_family():
    family = {BENCH / "reference" / "adm.py", BENCH / "program" / "adm.py"}
    for f in harness_files() + [BENCH / "README.md"]:
        text = f.read_text()
        for name in ("create_model", "wrap_precond", "GroupNorm32", "sigma_grid"):
            assert f in family or name not in text, (f, name)


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not imported(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "free_hunch_tpu_torch" not in imported(f), f
        assert not imported(f) - {"__future__", "contextlib", "dataclasses", "math", "pathlib",
                                  "typing", "numpy", "torch", "reference"}, f


def test_the_check_sees_whole_top_level_names():
    assert imported_names_match("free_hunch_tpu_torch.models") is False
    assert imported_names_match("free_hunch_tpu.models") is True
    assert imported_names_match("jaxtyping") is False


def imported_names_match(module: str) -> bool:
    import run
    import sys
    sys.modules.setdefault(module, None)
    try:
        return module.split(".")[0] in run.forbidden_modules()
    finally:
        if sys.modules.get(module) is None:
            del sys.modules[module]
