"""DataLoader (counterpart of monai_tpu/data/dataloader.py ``DataLoader``): batches of
a dataset's items, read by a pool of threads.

Each batch is its items read from the dataset (each through its transform) and
collated (``list_data_collate`` by default). With ``num_workers`` 0 the batches are read
in the iterating thread; otherwise ``num_workers`` threads read up to ``num_workers *
prefetch`` batches ahead, and the batches come out in the same order as with none.
Threads rather than torch's worker processes: the port's ``LoadImaged`` and
``Spacingd`` run on the card, which a forked process cannot use. The threads' card work
goes to the default stream that the main thread's work goes to, so the card runs it in
the order it is issued; what overlaps is the host's part, the NIfTI decode above all
(zlib lets go of the GIL while it inflates).
"""
from __future__ import annotations

from collections import deque
from collections.abc import Callable, Iterator
from concurrent.futures import ThreadPoolExecutor

import torch

from .utils import list_data_collate

__all__ = ["DataLoader"]


class DataLoader:
    """Iterate ``dataset`` in batches of ``batch_size``, shuffled each epoch where
    ``shuffle`` (a ``torch.randperm`` from ``generator``, else from torch's global
    generator, so that ``set_determinism`` fixes the order); ``drop_last`` drops a
    last short batch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, num_workers: int = 0,
                 collate_fn: Callable | None = None, drop_last: bool = False, generator: torch.Generator | None = None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(int(num_workers), 0)
        self.collate_fn = list_data_collate if collate_fn is None else collate_fn
        self.drop_last = drop_last
        self.prefetch = max(int(prefetch), 1)
        self.generator = generator

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> list[list[int]]:
        if self.shuffle:
            order = torch.randperm(len(self.dataset), generator=self.generator).tolist()
        else:
            order = list(range(len(self.dataset)))
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _fetch(self, indices: list[int]):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator:
        batches = deque(self._batches())
        if self.num_workers == 0:
            while batches:
                yield self._fetch(batches.popleft())
            return
        pool = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="DataLoader")
        try:
            ahead = deque(pool.submit(self._fetch, batches.popleft())
                          for _ in range(min(len(batches), self.num_workers * self.prefetch)))
            while ahead:
                batch = ahead.popleft().result()
                if batches:
                    ahead.append(pool.submit(self._fetch, batches.popleft()))
                yield batch
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
