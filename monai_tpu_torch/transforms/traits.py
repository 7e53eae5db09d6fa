"""Transform capability traits (counterpart of monai_tpu/transforms/traits.py)."""
from __future__ import annotations

__all__ = ["InvertibleTrait", "LazyTrait", "RandomizableTrait"]


class LazyTrait:
    """The transform can describe its action as a pending operation."""

    @property
    def lazy(self):
        raise NotImplementedError

    @lazy.setter
    def lazy(self, enabled: bool):
        raise NotImplementedError

    @property
    def requires_current_data(self):
        raise NotImplementedError


class InvertibleTrait:
    def inverse(self, data):
        raise NotImplementedError


class RandomizableTrait:
    """The transform draws random parameters: a cache of the deterministic transforms
    before it ends here (``data.dataset.CacheDataset``)."""
