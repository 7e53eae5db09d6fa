"""Metric helpers (counterpart of monai_tpu/metrics/utils.py: ``ignore_background`` and
``do_metric_reduction``)."""
from __future__ import annotations

import torch

from ..utils.enums import MetricReduction

__all__ = ["do_metric_reduction", "ignore_background"]


def ignore_background(y_pred: torch.Tensor, y: torch.Tensor):
    """Drop channel 0 of each (where it has more than one)."""
    return y_pred[:, 1:] if y_pred.shape[1] > 1 else y_pred, y[:, 1:] if y.shape[1] > 1 else y


def do_metric_reduction(f: torch.Tensor, reduction: str = MetricReduction.MEAN):
    """NaN-aware reduction of a (batch, class, ...) metric tensor, in float64: (reduced,
    the count of values that were not NaN). ``mean`` averages over the classes, then over
    the batch."""
    reduction = MetricReduction(str(reduction))
    f = torch.as_tensor(f).double()
    nans = torch.isnan(f)
    not_nans = (~nans).double()
    if reduction == MetricReduction.NONE:
        return f, not_nans
    f = torch.where(nans, 0.0, f)
    if reduction == MetricReduction.MEAN:
        nn_c = not_nans.sum(1)
        f_c = torch.where(nn_c > 0, f.sum(1) / nn_c.clamp_min(1), float("nan"))
        nn_b = (nn_c > 0).double().sum(0)
        f_out = torch.where(nn_b > 0, torch.nansum(f_c, 0) / nn_b.clamp_min(1), float("nan"))
        return f_out, nn_b
    if reduction == MetricReduction.SUM:
        return f.sum(), not_nans.sum()
    if reduction == MetricReduction.MEAN_BATCH:
        nn = not_nans.sum(0)
        return torch.where(nn > 0, f.sum(0) / nn.clamp_min(1), float("nan")), nn
    if reduction == MetricReduction.SUM_BATCH:
        return f.sum(0), not_nans.sum(0)
    if reduction == MetricReduction.MEAN_CHANNEL:
        nn = not_nans.sum(1)
        return torch.where(nn > 0, f.sum(1) / nn.clamp_min(1), float("nan")), nn
    return f.sum(1), not_nans.sum(1)
