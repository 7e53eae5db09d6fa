"""Engine handlers (counterpart of monai_tpu/handlers/handlers.py: ``StatsHandler`` and
``ValidationHandler``). The statistics go to a ``logging`` logger only."""
from __future__ import annotations

import logging
import sys
from collections.abc import Callable, Sequence

import torch

from ..engines.events import Events
from ..utils.enums import CommonKeys

__all__ = ["StatsHandler", "ValidationHandler"]

KEY_VAL_FORMAT = "{}: {:.4f} "
DEFAULT_TAG = "Loss"


class StatsHandler:
    """Log the iteration's loss (``tag_name``) at each iteration, and the engine's metrics
    and best key metric at each epoch, to the logger ``name`` (INFO, to standard output
    where it has no handler yet). Reading the loss waits for the card.
    ``iteration_print_logger`` and ``epoch_print_logger``, where given, are called with the
    engine in place of the default lines; ``global_epoch_transform`` maps the epoch the
    metrics line names, ``state_attributes`` are logged after it, and
    ``key_var_format`` formats a name and a value."""

    def __init__(self, iteration_log: bool | Callable = True, epoch_log: bool | Callable = True,
                 epoch_print_logger: Callable | None = None, iteration_print_logger: Callable | None = None,
                 output_transform: Callable = lambda x: x[0] if isinstance(x, (list, tuple)) else x,
                 global_epoch_transform: Callable = lambda x: x, state_attributes: Sequence[str] | None = None,
                 name: str | None = "StatsHandler", tag_name: str = DEFAULT_TAG,
                 key_var_format: str = KEY_VAL_FORMAT):
        self.iteration_log = iteration_log
        self.epoch_log = epoch_log
        self.epoch_print_logger = epoch_print_logger
        self.iteration_print_logger = iteration_print_logger
        self.output_transform = output_transform
        self.global_epoch_transform = global_epoch_transform
        self.state_attributes = state_attributes
        self.tag_name = tag_name
        self.key_var_format = key_var_format
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
        if self.iteration_print_logger is not None:
            self.iteration_print_logger(engine)
            return
        out = self.output_transform(engine.state.output)
        loss = out.get(CommonKeys.LOSS) if isinstance(out, dict) else None
        if loss is None:
            return
        value = float(torch.as_tensor(loss, dtype=torch.float64).mean())
        per_epoch = engine.state.epoch_length or "?"
        it = engine.state.iteration
        cur = (it - 1) % engine.state.epoch_length + 1 if engine.state.epoch_length else it
        self.logger.info(f"Epoch: {engine.state.epoch}/{engine.state.max_epochs}, Iter: {cur}/{per_epoch} -- "
                         + self.key_var_format.format(self.tag_name, value))

    def epoch_completed(self, engine) -> None:
        if self.epoch_print_logger is not None:
            self.epoch_print_logger(engine)
            return
        metrics = {k: v for k, v in engine.state.metrics.items() if isinstance(v, (int, float))}
        if metrics:
            self.logger.info(f"Epoch[{self.global_epoch_transform(engine.state.epoch)}] Metrics -- "
                             + "".join(self.key_var_format.format(k, metrics[k]) for k in sorted(metrics)))
        if engine.state.key_metric_name is not None:
            self.logger.info(f"Key metric: {engine.state.key_metric_name} best value: {engine.state.best_metric} "
                             f"at epoch: {engine.state.best_metric_epoch}")
        if self.state_attributes:
            self.logger.info("State values: " + "".join(f"{a}: {getattr(engine.state, a, None)}; "
                                                        for a in self.state_attributes))

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
