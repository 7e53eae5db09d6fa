"""Optional imports and instantiation by dotted path (counterpart of
monai_tpu/utils/module.py: ``optional_import``, ``locate``, ``instantiate``), as far as
the bundle runner needs them. The port's networks take ``generator=`` and ``device=``
arguments, so nothing is injected into a component's arguments."""
from __future__ import annotations

import functools
import importlib
import pdb
import warnings
from typing import Any

from .enums import CompInitMode

__all__ = ["OptionalImportError", "instantiate", "locate", "optional_import"]


class OptionalImportError(ImportError):
    """An optional dependency was used but could not be imported."""


class _Missing:
    """Stands in for what ``optional_import`` could not import, and raises at first use."""

    def __init__(self, msg: str, cause: BaseException):
        self._error = OptionalImportError(msg)
        self._error.__cause__ = cause

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self._error

    def __call__(self, *args, **kwargs):
        raise self._error

    def __getitem__(self, item):
        raise self._error

    def __iter__(self):
        raise self._error


def optional_import(module: str, name: str = "") -> tuple[Any, bool]:
    """``(module, True)``, or its attribute ``name``; where that cannot be imported,
    ``(stand-in that raises at first use, False)``."""
    try:
        obj = importlib.import_module(module)
        if name:
            obj = getattr(obj, name)
    except Exception as e:  # an ImportError, or any error the module raises as it imports
        what = f"import {module}" + (f".{name}" if name else "")
        return _Missing(f"{what} ({e})", e), False
    return obj, True


def locate(path: str) -> Any:
    """The object at dotted ``path``: the longest importable module prefix, then
    attributes."""
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj: Any = importlib.import_module(".".join(parts[:split]))
        except Exception:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ModuleNotFoundError(f"Cannot locate '{path}'.")


def instantiate(__path: str | Any, __mode: str = CompInitMode.DEFAULT, **kwargs: Any) -> Any:
    """Call the class or function at ``__path`` (a dotted path or the object) with
    ``kwargs``: ``default`` calls it, ``callable`` returns it (bound to ``kwargs`` where
    there are any), ``partial`` binds ``kwargs``, ``debug`` stops in pdb first."""
    component = locate(__path) if isinstance(__path, str) else __path
    mode = CompInitMode(__mode)
    if not callable(component):
        warnings.warn(f"Component {component} is not callable; returning it as it is.")
        return component
    try:
        if mode == CompInitMode.CALLABLE:
            return functools.partial(component, **kwargs) if kwargs else component
        if mode == CompInitMode.PARTIAL:
            return functools.partial(component, **kwargs)
        if mode == CompInitMode.DEBUG:
            warnings.warn(f"instantiating {component} with {kwargs}")
            pdb.set_trace()
        return component(**kwargs)
    except Exception as e:
        raise RuntimeError(f"Failed to instantiate component '{__path}' with kwargs: {kwargs}") from e
