"""Construction of objects from dotted names (the config names the dataset
class).

Counterpart of ``free_hunch_tpu/utils/dynamic.py`` without ``open_url``.
The JAX package's dataset class name and the reference's map to the port's
class, so a config written for either builds the port's dataset.
"""
from __future__ import annotations

import importlib
import re
from typing import Any, Tuple

_ALIASES = {
    "free_hunch_tpu.data.dataset.ImageFolderDataset":
        "free_hunch_tpu_torch.data.dataset.ImageFolderDataset",
    "training.dataset.ImageFolderDataset":
        "free_hunch_tpu_torch.data.dataset.ImageFolderDataset",
}


def get_module_from_obj_name(obj_name: str) -> Tuple[Any, str]:
    """Split 'pkg.mod.Class' into (imported module, 'Class')."""
    obj_name = _ALIASES.get(obj_name, obj_name)
    parts = obj_name.split(".")
    if parts[0] == "free_hunch_tpu":
        raise ImportError(f"{obj_name!r} names the JAX package, which the port does not "
                          f"import")
    for i in range(len(parts) - 1, 0, -1):
        try:
            module = importlib.import_module(".".join(parts[:i]))
            return module, ".".join(parts[i:])
        except ImportError:
            continue
    raise ImportError(f"cannot import any module prefix of {obj_name!r}")


def get_obj_by_name(name: str) -> Any:
    module, local = get_module_from_obj_name(name)
    obj = module
    for part in local.split("."):
        obj = getattr(obj, part)
    return obj


def call_func_by_name(*args, func_name: str, **kwargs) -> Any:
    return get_obj_by_name(func_name)(*args, **kwargs)


def construct_class_by_name(*args, class_name: str, **kwargs) -> Any:
    """Instantiate a class from its dotted name."""
    return get_obj_by_name(class_name)(*args, **kwargs)


def is_url(obj: Any) -> bool:
    return isinstance(obj, str) and re.match(r"^[a-z]+://", obj) is not None
