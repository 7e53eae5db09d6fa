"""Engine handlers (counterpart of monai_tpu/handlers/handlers.py: ``StatsHandler`` and
``ValidationHandler``). The statistics go to a ``logging`` logger only."""
from __future__ import annotations

import logging
import sys
from collections.abc import Callable

import torch

from ..engines.events import Events
from ..utils.enums import CommonKeys

__all__ = ["StatsHandler", "ValidationHandler"]

KEY_VAL_FORMAT = "{}: {:.4f} "
DEFAULT_TAG = "Loss"


class StatsHandler:
    """Log the iteration's loss (``tag_name``) at each iteration, and the engine's metrics
    and best key metric at each epoch, to the logger ``name`` (INFO, to standard output
    where it has no handler yet). Reading the loss waits for the card."""

    def __init__(self, iteration_log: bool = True, epoch_log: bool = True,
                 output_transform: Callable = lambda x: x[0] if isinstance(x, (list, tuple)) else x,
                 name: str | None = "StatsHandler", tag_name: str = DEFAULT_TAG):
        self.iteration_log = iteration_log
        self.epoch_log = epoch_log
        self.output_transform = output_transform
        self.tag_name = tag_name
        self.logger = logging.getLogger(name)
        self.logger.setLevel(logging.INFO)
        if not self.logger.handlers:
            console = logging.StreamHandler(sys.stdout)
            console.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
            self.logger.addHandler(console)

    def attach(self, engine) -> None:
        if self.iteration_log:
            engine.add_event_handler(Events.ITERATION_COMPLETED, self.iteration_completed)
        if self.epoch_log:
            engine.add_event_handler(Events.EPOCH_COMPLETED, self.epoch_completed)
        engine.add_event_handler(Events.EXCEPTION_RAISED, self.exception_raised)

    def iteration_completed(self, engine) -> None:
        out = self.output_transform(engine.state.output)
        loss = out.get(CommonKeys.LOSS) if isinstance(out, dict) else None
        if loss is None:
            return
        value = float(torch.as_tensor(loss, dtype=torch.float64).mean())
        per_epoch = engine.state.epoch_length or "?"
        it = engine.state.iteration
        cur = (it - 1) % engine.state.epoch_length + 1 if engine.state.epoch_length else it
        self.logger.info(f"Epoch: {engine.state.epoch}/{engine.state.max_epochs}, Iter: {cur}/{per_epoch} -- "
                         + KEY_VAL_FORMAT.format(self.tag_name, value))

    def epoch_completed(self, engine) -> None:
        metrics = {k: v for k, v in engine.state.metrics.items() if isinstance(v, (int, float))}
        if metrics:
            self.logger.info(f"Epoch[{engine.state.epoch}] Metrics -- "
                             + "".join(KEY_VAL_FORMAT.format(k, metrics[k]) for k in sorted(metrics)))
        if engine.state.key_metric_name is not None:
            self.logger.info(f"Key metric: {engine.state.key_metric_name} best value: {engine.state.best_metric} "
                             f"at epoch: {engine.state.best_metric_epoch}")

    def exception_raised(self, engine, e: Exception | None = None) -> None:
        self.logger.exception(f"Exception: {e}")
        if e is not None:
            raise e


class ValidationHandler:
    """Run ``validator`` (an evaluator) every ``interval`` epochs (``epoch_level``) or
    iterations."""

    def __init__(self, interval: int, validator, epoch_level: bool = True):
        if not hasattr(validator, "run"):
            raise TypeError(f"validator must have a run() method, got {type(validator).__name__}.")
        self.validator = validator
        self.interval = interval
        self.epoch_level = epoch_level

    def attach(self, engine) -> None:
        event = Events.EPOCH_COMPLETED if self.epoch_level else Events.ITERATION_COMPLETED
        engine.add_event_handler(event, self, every=self.interval)

    def __call__(self, engine) -> None:
        self.validator.run(engine.state.epoch)
