"""Metric protocol (counterpart of monai_tpu/metrics/metric.py): Metric, IterationMetric,
Cumulative and CumulativeIterationMetric. A cumulative metric keeps each call's result
as a tensor on its device and concatenates them when it aggregates; one process, no
cross-process gather yet."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

__all__ = ["Cumulative", "CumulativeIterationMetric", "IterationMetric", "Metric"]


class Metric(ABC):
    @abstractmethod
    def __call__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(f"Subclass {self.__class__.__name__} must implement this method.")


class IterationMetric(Metric):
    """A metric of a batch, or of a list of samples (each computed with a batch dim of 1)."""

    def __call__(self, y_pred, y=None, **kwargs):
        if isinstance(y_pred, (list, tuple)) or isinstance(y, (list, tuple)):
            if y is None:
                ret = [self._compute_tensor(p[None], None, **kwargs) for p in y_pred]
            else:
                ret = [self._compute_tensor(p[None], t[None], **kwargs) for p, t in zip(y_pred, y)]
            return torch.cat(ret, 0)
        return self._compute_tensor(y_pred, y, **kwargs)

    @abstractmethod
    def _compute_tensor(self, y_pred, y=None, **kwargs):
        raise NotImplementedError


class Cumulative:
    """Per-call results kept in buffers, concatenated along the batch dim on demand."""

    def __init__(self):
        self._buffers: list[list[torch.Tensor]] | None = None
        self.reset()

    def reset(self):
        self._buffers = None

    def extend(self, *data) -> None:
        """Append a batch of results to each buffer."""
        if self._buffers is None:
            self._buffers = [[] for _ in data]
        for b, d in zip(self._buffers, data):
            b.append(torch.atleast_1d(torch.as_tensor(d)).detach())

    def append(self, *data) -> None:
        """Append one result (a batch dim of 1 is added)."""
        if self._buffers is None:
            self._buffers = [[] for _ in data]
        for b, d in zip(self._buffers, data):
            b.append(torch.as_tensor(d).detach()[None])

    def get_buffer(self):
        if self._buffers is None:
            return None
        out = [torch.cat(b, 0) if b else None for b in self._buffers]
        return out[0] if len(out) == 1 else out

    def __len__(self) -> int:
        if self._buffers is None or not self._buffers[0]:
            return 0
        return sum(len(x) for x in self._buffers[0])


class CumulativeIterationMetric(Cumulative, IterationMetric):
    """An IterationMetric whose calls accumulate into the buffers."""

    def __init__(self):
        Cumulative.__init__(self)

    def __call__(self, y_pred, y=None, **kwargs):
        ret = IterationMetric.__call__(self, y_pred, y, **kwargs)
        if isinstance(ret, (list, tuple)):
            self.extend(*ret)
        else:
            self.extend(ret)
        return ret

    def aggregate(self, *args, **kwargs):
        raise NotImplementedError(f"Subclass {self.__class__.__name__} must implement this method.")
