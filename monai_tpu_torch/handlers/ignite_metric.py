"""``from_engine``, ``IgniteMetricHandler``, ``MeanDice`` and ``ROCAUC`` (counterpart of
monai_tpu/handlers/ignite_metric.py): pick keys out of an engine's output, and a
cumulative metric that an engine's ``key_metric`` or ``additional_metrics`` take. The
engine feeds such a metric each iteration's predictions and labels (stacked where it
decollated them), aggregates it at the epoch's end into ``state.metrics`` and resets it
(``engines.workflow.Workflow``)."""
from __future__ import annotations

from collections.abc import Callable

from ..metrics import DiceMetric, ROCAUCMetric
from ..utils.enums import MetricReduction
from ..utils.misc import ensure_tuple

__all__ = ["IgniteMetricHandler", "MeanDice", "ROCAUC", "from_engine"]


def from_engine(keys, first: bool = False):
    """A function that takes an engine's output (a dict, or a list of dicts where it was
    decollated) and returns the values under ``keys``: a tuple for a dict; for a list,
    each key's values over the items (only the first item's with ``first``), a tuple of
    them where there are several keys."""
    keys = ensure_tuple(keys)

    def _wrapper(data):
        if isinstance(data, dict):
            return tuple(data[k] for k in keys)
        if isinstance(data, list) and isinstance(data[0], dict):
            ret = [data[0][k] if first else [item[k] for item in data] for k in keys]
            return tuple(ret) if len(ret) > 1 else ret[0]
        return data

    return _wrapper


class IgniteMetricHandler:
    """A cumulative metric (``metric_fn``) for an engine's ``key_metric`` or
    ``additional_metrics``: called with (y_pred, y), ``aggregate``, ``reset``.
    ``output_transform`` is taken for the JAX package's signature: the engine hands the
    metric the predictions and labels itself."""

    def __init__(self, metric_fn, output_transform: Callable = lambda x: x):
        self.metric_fn = metric_fn
        self.output_transform = output_transform

    def __call__(self, y_pred, y=None):
        return self.metric_fn(y_pred, y)

    def aggregate(self, *args, **kwargs):
        return self.metric_fn.aggregate(*args, **kwargs)

    def reset(self) -> None:
        self.metric_fn.reset()


class MeanDice(IgniteMetricHandler):
    """The mean dice (``metrics.DiceMetric``) over an epoch's predictions and labels."""

    def __init__(self, include_background: bool = True, reduction: str = MetricReduction.MEAN,
                 num_classes: int | None = None, output_transform: Callable = lambda x: x):
        super().__init__(DiceMetric(include_background=include_background, reduction=reduction,
                                    num_classes=num_classes), output_transform)


class ROCAUC(IgniteMetricHandler):
    """The area under the ROC curve (``metrics.ROCAUCMetric``) over an epoch's predictions
    and labels, averaged over the classes by ``average``."""

    def __init__(self, average: str = "macro", output_transform: Callable = lambda x: x):
        super().__init__(ROCAUCMetric(average=average), output_transform)
