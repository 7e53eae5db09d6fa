"""Dice metric (counterpart of monai_tpu/metrics/meandice.py: ``compute_dice`` and
``DiceMetric``), in float64 on the inputs' device."""
from __future__ import annotations

import torch

from ..networks.utils import one_hot
from ..utils.enums import MetricReduction
from .metric import CumulativeIterationMetric
from .utils import do_metric_reduction, ignore_background

__all__ = ["DiceMetric", "compute_dice"]


def compute_dice(y_pred: torch.Tensor, y: torch.Tensor, include_background: bool = True,
                 ignore_empty: bool = True, num_classes: int | None = None) -> torch.Tensor:
    """Per-sample, per-class dice of binarised (B, C, *spatial) tensors: (B, C) float64.
    A class with an empty ground truth is NaN with ``ignore_empty``, else 1 where the
    prediction is empty too and 0 where it is not."""
    if num_classes is not None and y_pred.shape[1] == 1:
        y_pred = one_hot(y_pred, num_classes, dim=1)
        if y.shape[1] == 1:
            y = one_hot(y, num_classes, dim=1)
    if not include_background:
        y_pred, y = ignore_background(y_pred, y)
    if y.shape != y_pred.shape:
        raise ValueError(f"y_pred and y should have same shapes, got {tuple(y_pred.shape)} and {tuple(y.shape)}.")
    y, y_pred = y.double(), y_pred.double()
    axes = tuple(range(2, y_pred.ndim))
    intersection = (y * y_pred).sum(axes)
    y_o, y_pred_o = y.sum(axes), y_pred.sum(axes)
    denominator = y_o + y_pred_o
    dice = torch.where(denominator > 0, 2.0 * intersection / denominator.clamp_min(1e-12), float("nan"))
    if ignore_empty:
        return torch.where(y_o > 0, dice, float("nan"))
    return torch.where(y_o > 0, dice, (y_pred_o <= 0).double())


class DiceMetric(CumulativeIterationMetric):
    """Cumulative mean dice."""

    def __init__(self, include_background: bool = True, reduction: str = MetricReduction.MEAN,
                 get_not_nans: bool = False, ignore_empty: bool = True, num_classes: int | None = None):
        super().__init__()
        self.include_background = include_background
        self.reduction = reduction
        self.get_not_nans = get_not_nans
        self.ignore_empty = ignore_empty
        self.num_classes = num_classes

    def _compute_tensor(self, y_pred, y=None, **kwargs):
        if y is None:
            raise ValueError("y must be provided to compute the dice metric.")
        if y_pred.ndim < 3:
            raise ValueError(f"y_pred should have at least 3 dimensions (batch, channel, spatial), got {y_pred.ndim}.")
        return compute_dice(y_pred, y, self.include_background, self.ignore_empty, self.num_classes)

    def aggregate(self, reduction=None):
        data = self.get_buffer()
        if data is None:
            raise RuntimeError("the data to aggregate must be a synchronized array.")
        f, not_nans = do_metric_reduction(data, reduction or self.reduction)
        return (f, not_nans) if self.get_not_nans else f
