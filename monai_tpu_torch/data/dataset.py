"""Dataset (counterpart of monai_tpu/data/dataset.py ``Dataset``): a sequence of items
and the transform each goes through when it is read. ``CacheDataset`` waits for the
training bundle."""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch.utils.data

__all__ = ["Dataset"]


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
