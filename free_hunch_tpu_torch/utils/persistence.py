"""Source-embedding persistence for configured objects.

The port's own copy of ``free_hunch_tpu/utils/persistence.py`` (pure
Python): a class decorated with ``@persistent_class`` pickles with its
construction arguments, its source and its module's source, so a saved
object rebuilds even where its module has moved or vanished (``dumps`` /
``loads``).
"""
from __future__ import annotations

import copy
import inspect
import io
import pickle
import types
import uuid
from typing import Any

_VERSION = 1
_decorators = set()


def persistent_class(cls):
    """Class decorator: instances remember their construction args + source."""
    if cls in _decorators:
        return cls

    orig_init = cls.__init__

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "_init_args", copy.deepcopy(args))
        object.__setattr__(self, "_init_kwargs", copy.deepcopy(kwargs))
        orig_init(self, *args, **kwargs)

    def __reduce__(self):
        fields = dict(
            version=_VERSION,
            class_name=cls.__name__,
            module=cls.__module__,
            source=_class_source(cls),
            module_source=_module_source(cls),
            args=self._init_args,
            kwargs=self._init_kwargs,
            state=getattr(self, "__getstate__", lambda: self.__dict__)(),
        )
        return _reconstruct, (fields,)

    cls.__init__ = __init__
    cls.__reduce__ = __reduce__
    cls._is_persistent = True
    _decorators.add(cls)
    return cls


def _class_source(cls) -> str:
    import textwrap
    try:
        src = textwrap.dedent(inspect.getsource(cls))
    except (OSError, TypeError):
        return ""
    # strip decorator lines — they reference names unavailable at exec time
    lines = src.splitlines()
    while lines and lines[0].lstrip().startswith("@"):
        lines.pop(0)
    return "\n".join(lines)


def _module_source(cls) -> str:
    """Full source of the class's defining module (the reference embeds the
    whole module, persistence.py:_module_to_src — a bare class body cannot be
    exec'd when it has base classes or module-level references)."""
    import sys
    try:
        return inspect.getsource(sys.modules[cls.__module__])
    except (OSError, TypeError, KeyError):
        return ""


def _reconstruct(fields: dict) -> Any:
    if fields["version"] != _VERSION:
        raise ValueError(f"persistence: pickle version {fields['version']}, "
                         f"this module reads {_VERSION}")
    cls = None
    try:
        import importlib
        mod = importlib.import_module(fields["module"])
        cls = getattr(mod, fields["class_name"], None)
    except ImportError:
        cls = None
    if cls is None and fields.get("module_source"):
        # rebuild from the embedded MODULE source: its imports and base
        # classes execute too, so classes with bases / module-level
        # references survive (the class-body-only fallback below cannot)
        mod = types.ModuleType(f"_persistence_{uuid.uuid4().hex}")
        import sys
        sys.modules[mod.__name__] = mod  # dataclasses etc. look modules up
        exec(compile(fields["module_source"], "<persistence>", "exec"),
             mod.__dict__)
        cls = mod.__dict__.get(fields["class_name"])
    if cls is None and fields["source"]:
        # legacy pickles: rebuild the class body alone (base-less,
        # import-free classes only)
        mod = types.ModuleType(f"_persistence_{uuid.uuid4().hex}")
        exec(compile(fields["source"], "<persistence>", "exec"), mod.__dict__)
        cls = mod.__dict__[fields["class_name"]]
    obj = cls.__new__(cls)
    state = fields["state"]
    if hasattr(obj, "__setstate__"):
        obj.__setstate__(state)
    else:
        obj.__dict__.update(state)
    return obj


def is_persistent(obj) -> bool:
    return getattr(type(obj), "_is_persistent", False) or getattr(obj, "_is_persistent", False)


def dumps(obj) -> bytes:
    buf = io.BytesIO()
    pickle.dump(obj, buf)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    return pickle.loads(data)
