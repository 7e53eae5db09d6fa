"""The area under the ROC curve (counterpart of ``compute_roc_auc`` and ``ROCAUCMetric`` in
monai_tpu/metrics/regression.py), on the host in float64 numpy, as the JAX package
computes it: the predictions sorted, tied predictions counted as one step of the curve
(half a pair each way), and a class whose labels are all one value NaN, which the macro
and weighted averages carry through (torch MONAI's ``nanmean`` would skip it)."""
from __future__ import annotations

import warnings

import numpy as np

from ..utils.backend import to_numpy
from .metric import Cumulative, Metric

__all__ = ["ROCAUCMetric", "compute_roc_auc"]

_AVERAGES = ("macro", "weighted", "micro", "none")


def _calculate(y_pred: np.ndarray, y: np.ndarray) -> float:
    """One class's AUC: the share of (positive, negative) pairs ordered right, ties half."""
    if not np.all((y == 0) | (y == 1)):
        warnings.warn("y values must be 0 or 1; assuming binarized.")
    n = len(y)
    indices = np.argsort(y_pred)
    y, y_pred = y[indices], y_pred[indices]
    nneg = auc = tmp_pos = tmp_neg = 0.0
    for i in range(n):
        y_i = y[i]
        if i + 1 < n and y_pred[i] == y_pred[i + 1]:
            tmp_pos += y_i
            tmp_neg += 1 - y_i
            continue
        if tmp_pos + tmp_neg > 0:
            tmp_pos += y_i
            tmp_neg += 1 - y_i
            nneg += tmp_neg
            auc += tmp_pos * (nneg - tmp_neg / 2)
            tmp_pos = tmp_neg = 0
            continue
        if y_i == 1:
            auc += nneg
        else:
            nneg += 1
    denom = nneg * (n - nneg)
    return auc / denom if denom > 0 else float("nan")


def compute_roc_auc(y_pred, y, average: str = "macro"):
    """The AUC of predictions (B,) or (B, K) against binary labels of the same shape (a
    trailing axis of 1 is dropped): one class, or K classes averaged by ``average``
    ("macro", "weighted" by each class's positives, "micro" over all entries, or "none":
    the list)."""
    y_pred = to_numpy(y_pred).astype(np.float64)
    y = to_numpy(y).astype(np.float64)
    if y_pred.ndim not in (1, 2):
        raise ValueError(f"Predictions should be of shape (batch_size, num_classes) or (batch_size, ), got "
                         f"{y_pred.shape}.")
    if y.ndim not in (1, 2):
        raise ValueError(f"Targets should be of shape (batch_size, num_classes) or (batch_size, ), got {y.shape}.")
    if y_pred.ndim == 2 and y_pred.shape[1] == 1:
        y_pred = y_pred[:, 0]
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y_pred.ndim == 1:
        return _calculate(y_pred, y)
    if y.shape != y_pred.shape:
        raise ValueError(f"data shapes of y_pred and y do not match, got {y_pred.shape} and {y.shape}.")
    average = str(average).lower()
    if average not in _AVERAGES:
        raise ValueError(f"Unsupported average: {average}.")
    if average == "micro":
        return _calculate(y_pred.flatten(), y.flatten())
    auc_values = [_calculate(p, t) for p, t in zip(y_pred.T, y.T)]
    if average == "none":
        return auc_values
    if average == "macro":
        return float(np.mean(auc_values))
    return float(np.average(auc_values, weights=[np.sum(t) for t in y.T]))


class ROCAUCMetric(Cumulative, Metric):
    """The AUC over every (y_pred, y) it is called with since its last reset."""

    def __init__(self, average: str = "macro"):
        super().__init__()
        self.average = average

    def __call__(self, y_pred, y):
        self.extend(y_pred, y)

    def aggregate(self, average: str | None = None):
        y_pred, y = self.get_buffer()
        return compute_roc_auc(y_pred, y, average or self.average)
