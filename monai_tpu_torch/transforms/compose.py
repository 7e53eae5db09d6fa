"""Compose (counterpart of monai_tpu/transforms/compose.py): a sequence of transforms,
and its inverse. Where a transform returns a list of samples (a multi-sample crop), the
transforms after it run on each sample. A Compose seeds its random transforms, in order,
from ``utils.set_determinism``'s seed when it is made, as the JAX package's does. The
random containers (OneOf, RandomOrder, SomeOf) and a Compose-wide lazy mode are not
ported."""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import numpy as np

from ..utils.misc import ensure_tuple, get_seed
from .inverse import InvertibleTransform
from .lazy_executor import apply_pending_transforms
from .transform import MAX_SEED, Randomizable, apply_transform

__all__ = ["Compose", "execute_compose"]


def execute_compose(data, transforms: Sequence[Any], map_items: bool = True, start: int = 0,
                    end: int | None = None) -> Any:
    """Apply ``transforms[start:end]`` in order, then flush what is pending."""
    end_ = len(transforms) if end is None else end
    if start > end_:
        raise ValueError(f"start ({start}) > end ({end_})")
    for transform in transforms[start:end_]:
        data = apply_transform(transform, data, map_items)
    return apply_pending_transforms(data)


class Compose(Randomizable, InvertibleTransform):
    """Apply transforms in sequence; ``inverse`` undoes the invertible ones in reverse."""

    def __init__(self, transforms: Sequence[Any] | Callable | None = None, map_items: bool = True):
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
        """The same transforms with nested Composes unrolled."""
        flat = []
        for t in self.transforms:
            flat += t.flatten().transforms if isinstance(t, Compose) else [t]
        return Compose(flat, self.map_items)

    def __call__(self, input_, start: int = 0, end: int | None = None):
        return execute_compose(input_, self.transforms, self.map_items, start=start, end=end)

    def inverse(self, data):
        for t in reversed([t for t in self.flatten().transforms if isinstance(t, InvertibleTransform)]):
            data = apply_transform(t.inverse, data, self.map_items)
        return data
