"""Workflow engine (counterpart of monai_tpu/engines/workflow.py): the epoch and
iteration loop, its events, the engine state and the metrics fed from each iteration's
output. With ``decollate`` each iteration's output dict becomes the list of its items
(``data.utils.decollate_batch``), ``postprocessing`` runs on each item, and the batch
is decollated beside it; without, ``postprocessing`` runs on the whole output dict. The
metrics take ``pred`` and ``label`` (stacked again where decollated)."""
from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence
from typing import Any

import torch

from ..data.utils import decollate_batch
from ..transforms.transform import apply_transform
from ..utils.backend import resolve_device
from ..utils.enums import CommonKeys
from .events import EventEmitter, Events

__all__ = ["State", "Workflow"]


class State:
    """Engine state (ignite's ``State``)."""

    def __init__(self, **kwargs):
        self.rank = 0
        self.iteration = 0
        self.epoch = 0
        self.max_epochs = 1
        self.epoch_length: int | None = None
        self.output: Any = None
        self.batch: Any = None
        self.metrics: dict = {}
        self.dataloader: Any = None
        self.device: torch.device | None = None
        self.key_metric_name: str | None = None
        self.best_metric: float = -1
        self.best_metric_epoch: int = -1
        self.terminate = False
        for k, v in kwargs.items():
            setattr(self, k, v)


class Workflow(EventEmitter):
    """Epoch and iteration loop, events and metrics. ``device=None`` is the CUDA card
    (``utils.resolve_device``); pass ``device="cpu"`` for the CPU."""

    def __init__(self, device=None, max_epochs: int = 1, data_loader: Iterable | None = None,
                 epoch_length: int | None = None, non_blocking: bool = False, prepare_batch: Callable | None = None,
                 iteration_update: Callable | None = None, postprocessing: Callable | None = None,
                 key_metric: dict | None = None, additional_metrics: dict | None = None,
                 metric_cmp_fn: Callable = lambda cur, best: cur > best, handlers: Sequence | None = None,
                 amp: bool = False, decollate: bool = True):
        super().__init__()
        self.device = resolve_device(device)
        self.state = State(max_epochs=max_epochs, device=self.device)
        self.data_loader = data_loader
        self.non_blocking = non_blocking
        self.prepare_batch = prepare_batch
        self.metric_cmp_fn = metric_cmp_fn
        self.amp = amp
        self.postprocessing = postprocessing
        self.decollate = decollate
        self._iteration_update = iteration_update
        if epoch_length is None and data_loader is not None:
            try:
                epoch_length = len(data_loader)
            except TypeError:
                epoch_length = None
        self.state.epoch_length = epoch_length
        self.metrics: dict = {}
        if key_metric is not None:
            self.metrics.update(key_metric)
            self.state.key_metric_name = next(iter(key_metric))
        self.metrics.update(additional_metrics or {})
        if self.metrics:
            self.add_event_handler(Events.EPOCH_COMPLETED, Workflow._aggregate_metrics)
        for handler in handlers or ():
            if hasattr(handler, "attach"):
                handler.attach(self)
            else:
                self.add_event_handler(Events.ITERATION_COMPLETED, handler)

    def _aggregate_metrics(self) -> None:
        for name, metric in self.metrics.items():
            value = metric.aggregate()
            if isinstance(value, (tuple, list)):
                value = value[0]
            self.state.metrics[name] = float(torch.as_tensor(value).reshape(-1)[0])
            metric.reset()
        key = self.state.key_metric_name
        if key in self.state.metrics:
            current = self.state.metrics[key]
            if self.state.best_metric_epoch == -1 or self.metric_cmp_fn(current, self.state.best_metric):
                self.state.best_metric = current
                self.state.best_metric_epoch = self.state.epoch

    def _iteration(self, engine, batchdata) -> dict:
        raise NotImplementedError(f"Subclass {self.__class__.__name__} must implement this method.")

    def _apply_post_and_metrics(self) -> None:
        out = self.state.output
        if not isinstance(out, dict):
            return
        if self.decollate:
            items = decollate_batch(out)
            if self.postprocessing is not None:
                items = [apply_transform(self.postprocessing, item, map_items=False) for item in items]
            self.state.output = items
            if isinstance(self.state.batch, dict):
                self.state.batch = decollate_batch(self.state.batch)
            preds, labels = ([item.get(k) for item in items] for k in (CommonKeys.PRED, CommonKeys.LABEL))
            if not self.metrics or any(v is None for v in preds + labels):
                return
            pred, label = (torch.stack([getattr(v, "data", v) for v in vs]) for vs in (preds, labels))
        else:
            if self.postprocessing is not None:
                out = self.state.output = self.postprocessing(out)
            pred, label = out.get(CommonKeys.PRED), out.get(CommonKeys.LABEL)
            if pred is None or label is None:
                return
        for metric in self.metrics.values():
            metric(pred, label)

    def run(self) -> None:
        """The epochs, each over the data loader (at most ``epoch_length`` batches)."""
        if self.state.epoch_length == 0 or self.data_loader is None:
            return
        try:
            self.fire_event(Events.STARTED)
            while self.state.epoch < self.state.max_epochs and not self.state.terminate:
                self.state.epoch += 1
                self.fire_event(Events.EPOCH_STARTED)
                for it, batchdata in enumerate(self.data_loader, 1):
                    self.state.iteration += 1
                    self.state.batch = batchdata
                    self.fire_event(Events.ITERATION_STARTED)
                    update = self._iteration_update or self._iteration
                    self.state.output = update(self, batchdata)
                    self._apply_post_and_metrics()
                    self.fire_event(Events.ITERATION_COMPLETED)
                    if self.state.terminate or (self.state.epoch_length is not None and it >= self.state.epoch_length):
                        break
                self.fire_event(Events.EPOCH_COMPLETED)
            self.fire_event(Events.COMPLETED)
        except Exception as e:
            handlers = self._event_handlers.get(str(Events.EXCEPTION_RAISED), [])
            if not handlers:
                raise
            for handler, args, kwargs in list(handlers):
                handler(self, e, *args, **kwargs)

    def terminate(self) -> None:
        self.state.terminate = True

    def get_stats(self, *vars_name: str) -> dict:
        stats = {"rank": self.state.rank, "current_epoch": self.state.epoch,
                 "current_iteration": self.state.iteration, "total_epochs": self.state.max_epochs,
                 "total_iterations": self.state.epoch_length}
        for k in vars_name:
            stats[k] = getattr(self.state, k, None)
        return stats
