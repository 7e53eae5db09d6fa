"""Auto3DSeg's statistical operations (counterpart of monai_tpu/auto3dseg/operations.py):
``Operations``, a dict of named callables applied to one sample; ``SampleOperations``, the
statistics of one case's values; ``SummaryOperations``, those of the cases' statistics.

A tensor sample is reduced where it lies (the card by default): its values are flattened
and sorted once, and each operation takes that sorted tensor. max and min are exact, mean
and stdev are sums in float64, and the median and percentiles interpolate numpy's
"linear" way in float64 between two order statistics of the sort, so each number is
numpy's on the same float32 values within 1e-6 relative (numpy sums float32 in float32).
A sort, not ``torch.quantile``, which refuses more than 2^24 elements (a 512x512x90 CT has
23.6 M). A numpy sample (the summaries' host data) is reduced by numpy, as the JAX package
reduces every sample.
"""
from __future__ import annotations

from collections import UserDict
from functools import partial
from typing import Any

import numpy as np
import torch

__all__ = ["Operations", "SampleOperations", "SummaryOperations", "percentiles"]


class Operations(UserDict):
    """A dict of named callables; ``evaluate`` applies each to the data."""

    def evaluate(self, data: Any, **kwargs: Any) -> dict:
        return {k: v(data, **kwargs) for k, v in self.data.items() if callable(v)}


def percentiles(values: torch.Tensor, qs, presorted: bool = False) -> list[float]:
    """numpy's ``percentile(values, q)`` ("linear") for each q, from one sort of the
    flattened values (none where ``presorted``)."""
    s = values.reshape(-1) if presorted else torch.sort(values.reshape(-1)).values
    n = s.numel()
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        a, b = s[lo].item(), s[hi].item()
        out.append(float(a + (b - a) * (pos - lo)))
    return out


def _on_sorted(np_fn, sorted_fn):
    """numpy's ``np_fn`` on an array; on a tensor (flattened and sorted by
    ``SampleOperations.evaluate``), ``sorted_fn``."""
    def op(x, **kwargs):
        return sorted_fn(x, **kwargs) if isinstance(x, torch.Tensor) else np_fn(x, **kwargs)
    return op


def _np_percentile(x, q):
    return np.percentile(np.asarray(x), q)


class SampleOperations(Operations):
    """One case's max, mean, median, min, stdev (numpy's, ddof 0) and its 0.5th, 10th,
    90th and 99.5th percentiles, also under ``percentile_00_5`` ... ``percentile_99_5``."""

    def __init__(self):
        self.data = {
            "max": _on_sorted(np.max, lambda s: s[-1].item()),
            "mean": _on_sorted(np.mean, lambda s: s.double().mean().item()),
            "median": _on_sorted(np.median, lambda s: percentiles(s, (50.0,), presorted=True)[0]),
            "min": _on_sorted(np.min, lambda s: s[0].item()),
            "stdev": _on_sorted(np.std, lambda s: s.double().std(correction=0).item()),
            "percentile": _on_sorted(partial(_np_percentile, q=[0.5, 10, 90, 99.5]),
                                     lambda s: percentiles(s, (0.5, 10.0, 90.0, 99.5), presorted=True)),
        }
        self.data_addon = {
            "percentile_00_5": ("percentile", 0),
            "percentile_10_0": ("percentile", 1),
            "percentile_90_0": ("percentile", 2),
            "percentile_99_5": ("percentile", 3),
        }

    def evaluate(self, data: Any, **kwargs: Any) -> dict:
        data = getattr(data, "data", data) if not isinstance(data, np.ndarray) else data
        data = torch.sort(data.reshape(-1)).values if isinstance(data, torch.Tensor) else np.asarray(data)
        ret = super().evaluate(data, **kwargs)
        for k, (cache, idx) in self.data_addon.items():
            if cache in ret:
                ret[k] = ret[cache][idx]
        for k, v in ret.items():
            ret[k] = np.asarray(v).tolist()
        return ret


class SummaryOperations(Operations):
    """The cases' statistics summarised: max of the maxima, min of the minima, the mean of
    the rest (numpy, on the host)."""

    def __init__(self):
        self.data = {
            "max": np.max,
            "mean": np.mean,
            "median": np.mean,
            "min": np.min,
            "stdev": np.mean,
            "percentile_00_5": np.mean,
            "percentile_10_0": np.mean,
            "percentile_90_0": np.mean,
            "percentile_99_5": np.mean,
        }

    def evaluate(self, data: Any, **kwargs: Any) -> dict:
        return {k: np.asarray(v(data[k], **kwargs)).tolist()
                for k, v in self.data.items() if callable(v) and k in data}
