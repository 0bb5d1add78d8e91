"""Attribute-style dict used by the config and driver layers.

Counterpart of ``free_hunch_tpu/utils/easydict.py``.
"""
from typing import Any


class EasyDict(dict):
    """dict subclass that exposes keys as attributes."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]
