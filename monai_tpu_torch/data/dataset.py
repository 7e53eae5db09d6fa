"""Dataset and CacheDataset (counterpart of monai_tpu/data/dataset.py): a sequence of
items and the transform each goes through when it is read; ``CacheDataset`` keeps each
item as the transforms before the first random one leave it, and runs only the rest at
each read."""
from __future__ import annotations

import copy
import sys
from collections.abc import Callable, Sequence
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch.utils.data

from .utils import pickle_hashing

__all__ = ["CacheDataset", "Dataset"]


class Dataset(torch.utils.data.Dataset):
    """``data[index]`` through ``transform`` (a callable, or a sequence of them run as a
    ``Compose``), at each read; a slice or a sequence of indices gives a ``Subset``."""

    def __init__(self, data: Sequence, transform: Sequence[Callable] | Callable | None = None):
        from ..transforms.compose import Compose  # here: the transforms import this package

        self.data = data
        self.transform = transform if transform is None or isinstance(transform, Compose) else Compose(transform)

    def __len__(self) -> int:
        return len(self.data)

    def _transform(self, index: int):
        from ..transforms.transform import apply_transform

        item = self.data[index]
        return item if self.transform is None else apply_transform(self.transform, item)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return torch.utils.data.Subset(self, range(*index.indices(len(self))))
        if isinstance(index, Sequence):
            return torch.utils.data.Subset(self, index)
        return self._transform(index)


def _first_random_index(pipeline) -> int | None:
    """The index of the first transform that ends the deterministic prefix: a random one,
    or a callable that is not a ``Transform``."""
    from ..transforms.traits import RandomizableTrait
    from ..transforms.transform import Transform

    return pipeline.get_index_of_first(lambda t: isinstance(t, RandomizableTrait) or not isinstance(t, Transform))


class CacheDataset(Dataset):
    """A ``Dataset`` that runs the transforms before the first random one once for each of
    its first ``min(cache_num, len(data) * cache_rate)`` items, when it is made, and keeps
    the results where the transforms left them (the port's ``LoadImaged`` and ``Spacingd``
    leave them on the card). A read of a cached item runs the rest of the transforms on a
    deep copy of it (``copy_cache``; without, on the cached item itself, which a transform
    that changes its input in place then changes), so a transform that changes its input
    in place never reaches the cache; an item past the cache runs all of them.
    ``hash_as_key`` caches the items of distinct content (``hash_func``, the md5 of the
    pickle) once each, the first of each; ``runtime_cache`` fills each cached item at its
    first read instead of when the dataset is made. ``num_workers`` threads fill the cache
    (threads, not processes: the transforms run on the card). ``progress`` and
    ``as_contiguous`` are taken for the JAX package's signature."""

    def __init__(self, data: Sequence, transform: Sequence[Callable] | Callable | None = None,
                 cache_num: int = sys.maxsize, cache_rate: float = 1.0, num_workers: int | None = 1,
                 progress: bool = True, copy_cache: bool = True, as_contiguous: bool = True,
                 hash_as_key: bool = False, hash_func: Callable = pickle_hashing, runtime_cache: bool = False):
        super().__init__(data=data, transform=transform)
        self.set_num = cache_num
        self.set_rate = cache_rate
        self.num_workers = 1 if num_workers is None else max(int(num_workers), 1)
        self.copy_cache, self.hash_as_key, self.hash_func = copy_cache, hash_as_key, hash_func
        self.runtime_cache = runtime_cache
        self._hash_keys: list = []
        self.set_data(data)

    def set_data(self, data: Sequence) -> None:
        """Take a new list of items and fill the cache for it (at its reads, with
        ``runtime_cache``)."""
        self.data = data
        self._start = None if self.transform is None else _first_random_index(self.transform)
        if self.hash_as_key:
            unique: dict = {}
            for item in data:
                unique.setdefault(self.hash_func(item), item)
            self.cache_num = min(int(self.set_num), int(len(unique) * self.set_rate), len(unique))
            self._hash_keys = list(unique)[:self.cache_num]
            items = [unique[k] for k in self._hash_keys]
        else:
            self.cache_num = min(int(self.set_num), int(len(data) * self.set_rate), len(data))
            items = list(data[: self.cache_num])
        if self.runtime_cache:
            self._cache = [None] * self.cache_num
        elif self.num_workers > 1:
            with ThreadPoolExecutor(self.num_workers, thread_name_prefix="CacheDataset") as pool:
                self._cache = list(pool.map(self._load_cache_item, items))
        else:
            self._cache = [self._load_cache_item(item) for item in items]

    def _load_cache_item(self, item: Any):
        if self.transform is None:
            return item
        return self.transform(item, end=self._start)

    def _cache_index(self, index: int) -> int | None:
        if self.hash_as_key:
            key = self.hash_func(self.data[index])
            return self._hash_keys.index(key) if key in self._hash_keys else None
        return index if index < self.cache_num else None

    def _transform(self, index: int):
        at = self._cache_index(index)
        if at is None:
            return super()._transform(index)
        if self._cache[at] is None:  # runtime_cache: filled at the first read
            self._cache[at] = self._load_cache_item(self.data[index])
        item = copy.deepcopy(self._cache[at]) if self.copy_cache else self._cache[at]
        if self.transform is None or self._start is None:
            return item
        from ..transforms.transform import apply_transform

        return apply_transform(lambda x: self.transform(x, start=self._start), item, map_items=False)
