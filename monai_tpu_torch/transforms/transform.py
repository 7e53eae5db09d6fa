"""Transform base classes (counterpart of monai_tpu/transforms/transform.py: Transform,
MapTransform, LazyTransform, Randomizable, RandomizableTransform and apply_transform).

Random transforms draw their parameters on the host from a numpy ``RandomState`` of
their own, ``R``, as the JAX package's do, and a ``Compose`` seeds them from
``utils.set_determinism``'s seed in the same order: one seed gives the same draws, so
the same crops, flips, rotations and offsets, in both packages."""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Generator, Hashable, Mapping
from typing import Any

import numpy as np

from ..utils.misc import ensure_tuple
from .traits import LazyTrait, RandomizableTrait

__all__ = ["MAX_SEED", "Transform", "MapTransform", "LazyTransform", "Randomizable", "RandomizableTransform",
           "apply_transform"]

MAX_SEED = np.iinfo(np.uint32).max + 1


class Randomizable(RandomizableTrait):
    """Keeps a numpy ``RandomState`` ``R`` that ``randomize`` draws from."""

    R: np.random.RandomState = np.random.RandomState()

    def set_random_state(self, seed: int | None = None,
                         state: np.random.RandomState | None = None) -> "Randomizable":
        """``R`` seeded with ``seed`` (modulo ``MAX_SEED``), else ``state`` itself, else a
        fresh unseeded one."""
        if seed is not None:
            self.R = np.random.RandomState((int(seed) if isinstance(seed, (int, np.integer)) else id(seed))
                                           % MAX_SEED)
        elif state is not None:
            if not isinstance(state, np.random.RandomState):
                raise TypeError(f"state must be a RandomState, got {type(state).__name__}")
            self.R = state
        else:
            self.R = np.random.RandomState()
        return self

    def randomize(self, data: Any) -> None:
        raise NotImplementedError(f"Subclass {self.__class__.__name__} must implement this method.")


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


class RandomizableTransform(Randomizable, Transform):
    """A random transform applied with probability ``prob``: ``randomize`` draws
    ``R.rand() < prob`` first."""

    def __init__(self, prob: float = 1.0, do_transform: bool = True):
        self._do_transform = do_transform
        self.prob = min(max(prob, 0.0), 1.0)

    def randomize(self, data: Any) -> None:
        self._do_transform = self.R.rand() < self.prob


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


def _apply_transform(transform: Callable, data: Any, lazy: bool | None = None):
    from .lazy_executor import apply_pending_transforms_in_order

    data = apply_pending_transforms_in_order(transform, data, lazy)
    return transform(data, lazy=lazy) if isinstance(transform, LazyTrait) else transform(data)


def apply_transform(transform: Callable, data: Any, map_items: bool = True, lazy: bool | None = None) -> Any:
    """Apply ``transform`` to ``data``, to each item where ``data`` is a list or tuple and
    ``map_items`` is set; a failure is raised with the transform named. ``lazy`` is given
    to a lazy-capable transform (None: its own setting)."""
    try:
        if isinstance(data, (list, tuple)) and map_items:
            return [_apply_transform(transform, item, lazy) for item in data]
        return _apply_transform(transform, data, lazy)
    except Exception as e:
        raise RuntimeError(f"applying transform {transform}") from e
