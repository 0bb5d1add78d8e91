"""Construction of objects from dotted names (the config names the dataset
class), and ``open_url``.

Counterpart of ``free_hunch_tpu/utils/dynamic.py``. The JAX package's
dataset class name and the reference's map to the port's class, so a
config written for either builds the port's dataset. ``open_url`` opens
local paths, ``file://`` URLs and, for other URLs, only a file already in
the download cache: nothing is fetched.
"""
from __future__ import annotations

import glob
import hashlib
import importlib
import os
import re
from typing import Any, Optional, Tuple

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


def open_url(url: str, cache_dir: Optional[str] = None, return_filename: bool = False):
    """Open (``rb``) a local path, a ``file://`` URL, or a URL whose file is
    in ``cache_dir`` (default ``$XDG_CACHE_HOME/free_hunch_tpu``, else
    ``~/.cache/free_hunch_tpu``) as ``<md5 of the url>_<name>``; with
    ``return_filename`` the path instead. Any other URL raises ``IOError``:
    nothing is downloaded."""
    if not is_url(url):
        return url if return_filename else open(url, "rb")
    if url.startswith("file://"):
        path = url[len("file://"):]
        return path if return_filename else open(path, "rb")
    cache_dir = cache_dir or os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")), "free_hunch_tpu")
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    hits = sorted(glob.glob(os.path.join(cache_dir, f"{url_md5}_*")))
    if hits:
        return hits[0] if return_filename else open(hits[0], "rb")
    raise IOError(f"cannot fetch {url!r}: the port downloads nothing, and {cache_dir} holds "
                  f"no cache entry (a file named {url_md5}_<name>)")
