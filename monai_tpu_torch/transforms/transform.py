"""Transform base classes (counterpart of monai_tpu/transforms/transform.py: Transform,
MapTransform, LazyTransform and apply_transform; the randomized ones wait for the
training slice)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Generator, Hashable, Mapping
from typing import Any

from ..utils.misc import ensure_tuple
from .traits import LazyTrait

__all__ = ["Transform", "MapTransform", "LazyTransform", "apply_transform"]


class Transform(ABC):
    """A callable over a tensor, a MetaImage or a dict of them."""

    @abstractmethod
    def __call__(self, data: Any):
        raise NotImplementedError(f"Subclass {self.__class__.__name__} must implement this method.")


class LazyTransform(Transform, LazyTrait):
    """A transform that records its spatial action as a pending operation; with
    ``lazy=False`` (the default) it resamples at once."""

    def __init__(self, lazy: bool | None = False):
        self.lazy = lazy

    @property
    def lazy(self):
        return self._lazy

    @lazy.setter
    def lazy(self, lazy: bool | None):
        if lazy is not None and not isinstance(lazy, bool):
            raise TypeError(f"lazy must be a bool or None, got {type(lazy)}")
        self._lazy = lazy

    @property
    def requires_current_data(self):
        return False


class MapTransform(Transform):
    """A transform of the entries ``keys`` of a dict."""

    def __init__(self, keys, allow_missing_keys: bool = False):
        self.keys: tuple[Hashable, ...] = ensure_tuple(keys)
        self.allow_missing_keys = allow_missing_keys
        if not self.keys:
            raise ValueError("keys must be non-empty")
        for key in self.keys:
            if not isinstance(key, Hashable):
                raise TypeError(f"keys must be hashable, got {type(key).__name__}")

    def key_iterator(self, data: Mapping[Hashable, Any], *extra_iterables) -> Generator:
        """Each key of ``keys`` that ``data`` has; with extra iterables, ``(key, *extras)``
        zipped positionally against ``keys``."""
        extras = extra_iterables if extra_iterables else ((None,) * len(self.keys),)
        for entry in zip(self.keys, *extras):
            key = entry[0]
            if key not in data:
                if self.allow_missing_keys:
                    continue
                raise KeyError(f"{self.__class__.__name__}: required key {key!r} not found in data "
                               "(pass allow_missing_keys=True to skip absent keys).")
            yield entry if extra_iterables else key


def _apply_transform(transform: Callable, data: Any):
    from .lazy_executor import apply_pending_transforms_in_order

    return transform(apply_pending_transforms_in_order(transform, data))


def apply_transform(transform: Callable, data: Any, map_items: bool = True) -> Any:
    """Apply ``transform`` to ``data``, to each item where ``data`` is a list or tuple and
    ``map_items`` is set; a failure is raised with the transform named."""
    try:
        if isinstance(data, (list, tuple)) and map_items:
            return [_apply_transform(transform, item) for item in data]
        return _apply_transform(transform, data)
    except Exception as e:
        raise RuntimeError(f"applying transform {transform}") from e
