"""Compose and the random containers (counterpart of monai_tpu/transforms/compose.py):
``Compose``, a sequence of transforms, and its inverse; ``OneOf``, one transform drawn by
weight; ``RandomOrder``, all of them in a drawn order; ``SomeOf``, a drawn number of them in
a drawn order. Where a transform returns a list of samples (a multi-sample crop), the
transforms after it run on each sample. A Compose seeds its random transforms, in order,
from ``utils.set_determinism``'s seed when it is made, as the JAX package's does, and a
container draws from its own ``R`` as the JAX one does, so one seed gives the same choices
in both packages. A container records its choice on each image (a dict's images that
carry a trace), and its inverse undoes the transforms it ran, in reverse.

``lazy`` (a Compose's, or a call's) is given to every lazy-capable transform: False runs
each at once, True lets their operations pend and fuse into as few resamples as their
settings allow (flushed at the end, and before a transform that is not lazy), None leaves
each transform's own setting.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import numpy as np

from ..data.meta_image import MetaImage
from ..utils.enums import TraceKeys
from ..utils.misc import ensure_tuple, get_seed
from .inverse import InvertibleTransform
from .lazy_executor import apply_pending_transforms
from .transform import MAX_SEED, LazyTransform, Randomizable, apply_transform

__all__ = ["Compose", "OneOf", "RandomOrder", "SomeOf", "execute_compose"]


def execute_compose(data, transforms: Sequence[Any], map_items: bool = True, start: int = 0,
                    end: int | None = None, lazy: bool | None = False) -> Any:
    """Apply ``transforms[start:end]`` in order (``lazy`` given to the lazy-capable ones),
    then flush what is pending."""
    end_ = len(transforms) if end is None else end
    if start > end_:
        raise ValueError(f"start ({start}) > end ({end_})")
    for transform in transforms[start:end_]:
        data = apply_transform(transform, data, map_items, lazy=lazy)
    return apply_pending_transforms(data)


class Compose(Randomizable, InvertibleTransform, LazyTransform):
    """Apply transforms in sequence; ``inverse`` undoes the invertible ones in reverse."""

    def __init__(self, transforms: Sequence[Any] | Callable | None = None, map_items: bool = True,
                 lazy: bool | None = False):
        LazyTransform.__init__(self, lazy=lazy)
        self.transforms = ensure_tuple([] if transforms is None else transforms)
        self.map_items = map_items
        self.set_random_state(seed=get_seed())

    def set_random_state(self, seed: int | None = None, state: np.random.RandomState | None = None) -> "Compose":
        """Seed this Compose's ``R``, then each random transform with a seed drawn from it."""
        super().set_random_state(seed=seed, state=state)
        for t in self.transforms:
            if isinstance(t, Randomizable):
                t.set_random_state(seed=self.R.randint(MAX_SEED, dtype="uint32"))
        return self

    def get_index_of_first(self, predicate: Callable[[Any], bool]) -> int | None:
        """The index of the first transform for which ``predicate`` holds, else None."""
        return next((i for i, t in enumerate(self.transforms) if predicate(t)), None)

    def flatten(self) -> "Compose":
        """The same transforms with nested Composes unrolled (the random containers kept
        whole)."""
        flat = []
        for t in self.transforms:
            flat += t.flatten().transforms if isinstance(t, Compose) and not isinstance(t, _Container) else [t]
        return Compose(flat, self.map_items, self.lazy)

    def __len__(self) -> int:
        return len(self.flatten().transforms)

    def __call__(self, input_, start: int = 0, end: int | None = None, lazy: bool | None = None):
        return execute_compose(input_, self.transforms, self.map_items, start=start, end=end,
                               lazy=self.lazy if lazy is None else lazy)

    def inverse(self, data):
        for t in reversed([t for t in self.flatten().transforms if isinstance(t, InvertibleTransform)]):
            data = apply_transform(t.inverse, data, self.map_items)
        return data


def _traced(data) -> list:
    """The keys of a dict's images that carry a trace (a MetaImage: ``[None]``)."""
    if isinstance(data, MetaImage):
        return [None]
    if isinstance(data, dict):
        return [k for k, v in data.items() if isinstance(v, MetaImage) and v.applied_operations]
    return []


class _Container(Compose):
    """A random container: its choice is recorded on the images it ran on."""

    def _record(self, data, extra_info: dict, keys: list):
        entry = {TraceKeys.CLASS_NAME: self.__class__.__name__, TraceKeys.ID: id(self), TraceKeys.EXTRA_INFO: extra_info}
        if isinstance(data, MetaImage):
            data = data.new_like(data.data)
            data.push_applied_operation({**entry, TraceKeys.ORIG_SIZE: data.peek_pending_shape()})
            return data
        data = dict(data)
        for key in keys:
            data[key] = data[key].new_like(data[key].data)
            data[key].push_applied_operation({**entry, TraceKeys.ORIG_SIZE: data[key].peek_pending_shape()})
        return data

    def _pop_record(self, data) -> tuple[Any, dict | None]:
        """``data`` without this container's records; the last one popped."""
        info = None
        if isinstance(data, MetaImage):
            data = data.new_like(data.data)
            info = self.get_most_recent_transform(data, pop=True)[TraceKeys.EXTRA_INFO]
        elif isinstance(data, dict):
            data = dict(data)
            for key in _traced(data):
                data[key] = data[key].new_like(data[key].data)
                info = self.get_most_recent_transform(data[key], pop=True)[TraceKeys.EXTRA_INFO]
        if info is None:
            raise RuntimeError(f"No previous {self.__class__.__name__} transform recorded.")
        return data, info

    def _run(self, data, order: Sequence[int], lazy: bool | None, extra_info: dict, keys_of=None):
        lazy_ = self.lazy if lazy is None else lazy
        for i in order:
            data = apply_transform(self.transforms[i], data, self.map_items, lazy=lazy_)
        # flushed first, so that the record lies above the operations it undoes (the JAX
        # package records first, and its inverse of a lazy run fails on the order)
        data = apply_pending_transforms(data)
        return self._record(data, extra_info, _traced(data) if keys_of is None else keys_of(data))

    def _invert(self, data, order: Sequence[int]):
        for i in reversed(order):
            if isinstance(self.transforms[i], InvertibleTransform):
                data = apply_transform(self.transforms[i].inverse, data, self.map_items)
        return data


def _normalized(weights) -> list:
    w = np.asarray(weights, dtype=float)
    if np.any(w < 0):
        raise ValueError("Probabilities must be greater than or equal to zero.")
    if np.all(w == 0):
        raise ValueError("At least one probability must be greater than zero.")
    return (w / w.sum()).tolist()


class OneOf(_Container):
    """Run one of ``transforms``, drawn by ``weights`` (default equal)."""

    def __init__(self, transforms=None, weights=None, map_items: bool = True, lazy: bool | None = False):
        super().__init__(transforms, map_items, lazy)
        if len(self.transforms) == 0:
            weights = []
        elif weights is None or isinstance(weights, float):
            weights = [1.0 / len(self.transforms)] * len(self.transforms)
        if len(weights) != len(self.transforms):
            raise ValueError("transforms and weights should be same size if both specified as sequences.")
        self.weights = ensure_tuple(_normalized(weights) if len(weights) else weights)

    def flatten(self) -> "OneOf":
        transforms, weights = [], []
        for t, w in zip(self.transforms, self.weights):
            if isinstance(t, OneOf):
                inner = t.flatten()
                transforms += list(inner.transforms)
                weights += [w_ * w for w_ in inner.weights]
            else:
                transforms.append(t)
                weights.append(w)
        return OneOf(transforms, weights, self.map_items, self.lazy)

    def __call__(self, data, start: int = 0, end: int | None = None, lazy: bool | None = None):
        if len(self.transforms) == 0:
            return data
        index = int(self.R.multinomial(1, self.weights).argmax())
        return self._run(data, [index], lazy, {"index": index})

    def inverse(self, data):
        if len(self.transforms) == 0:
            return data
        data, info = self._pop_record(data)
        return self._invert(data, [info["index"]])


class RandomOrder(_Container):
    """Run every transform, in an order drawn anew each call."""

    def __call__(self, input_, start: int = 0, end: int | None = None, lazy: bool | None = None):
        if len(self.transforms) == 0:
            return input_
        order = [int(i) for i in self.R.permutation(range(len(self.transforms)))]
        return self._run(input_, order, lazy, {"applied_order": order}, keys_of=_images)

    def inverse(self, data):
        if len(self.transforms) == 0:
            return data
        data, info = self._pop_record(data)
        return self._invert(data, info["applied_order"])


def _images(data) -> list:
    """The keys of a dict's images, traced or not (RandomOrder and SomeOf record on all)."""
    if isinstance(data, dict):
        return [k for k, v in data.items() if isinstance(v, MetaImage)]
    return []


class SomeOf(_Container):
    """Run a drawn number (``num_transforms``: a count, or a (min, max) range; default 0 to
    all) of ``transforms``, drawn by ``weights`` with or without ``replace``ment, in the
    order drawn."""

    def __init__(self, transforms=None, map_items: bool = True, num_transforms: int | tuple[int, int] | None = None,
                 replace: bool = False, weights: list | None = None, lazy: bool | None = False):
        super().__init__(transforms, map_items, lazy)
        self.min_num_transforms, self.max_num_transforms = self._ensure_valid_num_transforms(num_transforms)
        self.replace = replace
        self.weights = None if weights is None or len(self.transforms) == 0 else _normalized(weights)

    def _ensure_valid_num_transforms(self, num_transforms) -> tuple[int, int]:
        if num_transforms is None:
            return 0, len(self.transforms)
        if isinstance(num_transforms, int):
            n = min(num_transforms, len(self.transforms))
            return n, n
        if isinstance(num_transforms, (tuple, list)) and len(num_transforms) == 2:
            return int(num_transforms[0]), int(num_transforms[1])
        raise ValueError(f"Invalid num_transforms: {num_transforms}")

    def __call__(self, data, start: int = 0, end: int | None = None, lazy: bool | None = None):
        if len(self.transforms) == 0:
            return data
        n = self.R.randint(self.min_num_transforms, self.max_num_transforms + 1)
        order = [int(i) for i in self.R.choice(len(self.transforms), n, replace=self.replace, p=self.weights)]
        return self._run(data, order, lazy, {"applied_order": order}, keys_of=_images)

    def inverse(self, data):
        if len(self.transforms) == 0:
            return data
        data, info = self._pop_record(data)
        return self._invert(data, info["applied_order"])
