"""Auto3DSeg's case and summary analyzers (counterpart of monai_tpu/auto3dseg/analyzer.py):
``ImageStats``, ``FgImageStats``, ``LabelStats``, ``FilenameStats`` and ``ImageHistogram``
each add one case's report to its data dict; ``ImageStatsSumm``, ``FgImageStatsSumm``,
``LabelStatsSumm`` and ``ImageHistogramSumm`` summarise a list of them.

A case is reduced where its tensors lie (the card by default; ``operations`` says how, and
each number is the JAX package's numpy one within 1e-6 relative): shapes, counts, labels
and histogram counts exactly. A histogram takes numpy's bin edges (``np.histogram``'s, made
on the host in the edges' type) and counts each value in the bin whose edges hold it, the
last bin closed, as numpy's corrected indices do; ``torch.histc`` bins float32 values at
the edges differently. Connected components are scipy's ``ndimage.label`` of the mask on
the host. The summaries run on the host with numpy, as the JAX package's.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import numpy as np
import torch

from ..data.meta_image import MetaImage
from ..transforms.transform import MapTransform
from ..utils.backend import to_numpy
from ..utils.enums import DataStatsKeys, ImageStatsKeys, LabelStatsKeys
from .operations import Operations, SampleOperations, SummaryOperations

__all__ = ["Analyzer", "ImageStats", "FgImageStats", "LabelStats", "ImageStatsSumm", "FgImageStatsSumm",
           "LabelStatsSumm", "FilenameStats", "ImageHistogram", "ImageHistogramSumm"]


def _arr(x) -> torch.Tensor:
    """A MetaImage's tensor, a tensor, or an array as a CPU tensor."""
    x = x.data if isinstance(x, MetaImage) else x
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _histogram(values: torch.Tensor, bins: int, value_range) -> tuple[list[int], list[float]]:
    """``np.histogram(values, bins, range)``'s counts and edges, the counting where
    ``values`` lie: value v falls in bin i where edge i <= v < edge i + 1 (the last bin
    also holds its right edge) in the edges' type; values outside the edges are dropped."""
    np_dtype = torch.empty(0, dtype=values.dtype).numpy().dtype
    edges = np.histogram_bin_edges(np.empty(0, dtype=np_dtype), bins=bins, range=tuple(value_range))
    e = torch.from_numpy(edges).to(values.device)
    v = values.reshape(-1).to(e.dtype)
    v = v[(v >= e[0]) & (v <= e[-1])]
    idx = (torch.bucketize(v, e, right=True) - 1).clamp_(max=bins - 1)
    counts = torch.bincount(idx, minlength=bins)
    return counts.tolist(), edges.tolist()


class Analyzer(MapTransform, ABC):
    """A case's (or a summary's) analyzer: ``stats_name`` is its report's key, and
    ``report_format`` its keys, whose operations ``update_ops`` sets."""

    def __init__(self, stats_name: str, report_format: dict):
        super().__init__(None)
        self.stats_name = stats_name
        self.report_format = dict(report_format)
        self.ops: dict = {}

    def update_ops(self, key: str, op: Operations):
        self.ops[key] = op
        if key in self.report_format:
            self.report_format[key] = op

    def get_report_format(self) -> dict:
        return {k: (None if isinstance(v, Operations) else v) for k, v in self.report_format.items()}

    @abstractmethod
    def __call__(self, data: Any) -> dict:
        ...


class ImageStats(Analyzer):
    """A case's image: shape, channels, cropped shape, spacing, size in mm, intensities."""

    def __init__(self, image_key: str, stats_name: str = DataStatsKeys.IMAGE_STATS):
        report = {ImageStatsKeys.SHAPE: None, ImageStatsKeys.CHANNELS: None, ImageStatsKeys.CROPPED_SHAPE: None,
                  ImageStatsKeys.SPACING: None, ImageStatsKeys.SIZEMM: None, ImageStatsKeys.INTENSITY: None}
        super().__init__(stats_name, report)
        self.image_key = image_key
        self.update_ops(ImageStatsKeys.INTENSITY, SampleOperations())

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        img = d[self.image_key]
        arr = _arr(img)
        nda = arr if arr.ndim == 4 else arr[None] if arr.ndim == 3 else torch.atleast_3d(arr)[None]
        spacing = [1.0] * (nda.ndim - 1)
        if isinstance(img, MetaImage) and img.affine is not None:
            aff = np.asarray(to_numpy(img.affine))
            n = min(aff.shape[0] - 1, nda.ndim - 1)
            spacing = np.sqrt((aff[:n, :n] ** 2).sum(0)).tolist()
        shape = list(nda.shape[1:])
        # as the JAX package: the first axis's index of the first and of the last positive
        # voxel of channel 0 (in C order)
        rows = (nda[0] > 0).reshape(nda.shape[1], -1).any(1).nonzero().reshape(-1).tolist()
        report = {
            ImageStatsKeys.SHAPE: [shape],
            ImageStatsKeys.CHANNELS: nda.shape[0],
            ImageStatsKeys.CROPPED_SHAPE: [[rows[0], rows[-1]] if rows else shape],
            ImageStatsKeys.SPACING: [spacing],
            ImageStatsKeys.SIZEMM: [[s * sp for s, sp in zip(shape, spacing)]],
            ImageStatsKeys.INTENSITY: [self.ops[ImageStatsKeys.INTENSITY].evaluate(nda)],
        }
        d[self.stats_name] = report
        return d


class FgImageStats(Analyzer):
    """A case's intensities where its label is positive."""

    def __init__(self, image_key: str, label_key: str, stats_name: str = DataStatsKeys.FG_IMAGE_STATS):
        super().__init__(stats_name, {ImageStatsKeys.INTENSITY: None})
        self.image_key = image_key
        self.label_key = label_key
        self.update_ops(ImageStatsKeys.INTENSITY, SampleOperations())

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        img, lab = _arr(d[self.image_key]), _arr(d[self.label_key])
        fg = img[(lab > 0).expand(img.shape)]
        if fg.numel() == 0:
            fg = torch.zeros(1, dtype=img.dtype, device=img.device)
        d[self.stats_name] = {ImageStatsKeys.INTENSITY: [self.ops[ImageStatsKeys.INTENSITY].evaluate(fg)]}
        return d


class LabelStats(Analyzer):
    """A case's labels: each label's intensities, voxel share and (``do_ccp``) connected
    components' voxel counts."""

    def __init__(self, image_key: str, label_key: str, stats_name: str = DataStatsKeys.LABEL_STATS,
                 do_ccp: bool = True):
        report = {LabelStatsKeys.LABEL_UID: None, LabelStatsKeys.IMAGE_INTST: None, LabelStatsKeys.LABEL: None,
                  LabelStatsKeys.PIXEL_PCT: None}
        super().__init__(stats_name, report)
        self.image_key = image_key
        self.label_key = label_key
        self.do_ccp = do_ccp
        self.update_ops(LabelStatsKeys.IMAGE_INTST, SampleOperations())

    def __call__(self, data: dict) -> dict:
        from scipy import ndimage as ndi

        d = dict(data)
        img, lab = _arr(d[self.image_key]), _arr(d[self.label_key])
        lab2 = lab[0] if lab.ndim == img.ndim and lab.shape[0] == 1 else lab
        uids = [int(v) for v in torch.unique(lab2).tolist()]
        total = lab2.numel()
        per_label, pixel_pct = [], []
        for uid in uids:
            mask = lab2 == uid
            selected = img[(mask[None] if img.ndim == mask.ndim + 1 else mask).expand(img.shape)]
            entry = {LabelStatsKeys.IMAGE_INTST: self.ops[LabelStatsKeys.IMAGE_INTST].evaluate(selected)}
            if self.do_ccp:
                labeled, ncomp = ndi.label(mask.cpu().numpy())
                entry[LabelStatsKeys.LABEL_SHAPE] = np.bincount(labeled.ravel())[1:].tolist()
                entry[LabelStatsKeys.LABEL_NCOMP] = int(ncomp)
            per_label.append(entry)
            pixel_pct.append({uid: float(mask.sum().item()) / total})
        d[self.stats_name] = {
            LabelStatsKeys.LABEL_UID: uids,
            LabelStatsKeys.IMAGE_INTST: [e[LabelStatsKeys.IMAGE_INTST] for e in per_label],
            LabelStatsKeys.LABEL: per_label,
            LabelStatsKeys.PIXEL_PCT: pixel_pct,
        }
        return d


class ImageStatsSumm(Analyzer):
    """The cases' ``ImageStats`` summarised."""

    def __init__(self, stats_name: str = DataStatsKeys.IMAGE_STATS, average: bool = True):
        super().__init__(stats_name, {})
        self.average = average
        self.summary_op = SummaryOperations()

    def __call__(self, data: list) -> dict:
        stats = [d[self.stats_name] for d in data]
        shapes = np.asarray([s[ImageStatsKeys.SHAPE][0] for s in stats], dtype=np.float64)
        spacings = np.asarray([s[ImageStatsKeys.SPACING][0] for s in stats], dtype=np.float64)
        sample_op = SampleOperations()
        intensity_keys = stats[0][ImageStatsKeys.INTENSITY][0].keys()
        intensity = {k: np.asarray([s[ImageStatsKeys.INTENSITY][0][k] for s in stats]) for k in intensity_keys}
        return {
            ImageStatsKeys.SHAPE: sample_op.evaluate(shapes),
            ImageStatsKeys.CHANNELS: sample_op.evaluate(
                np.asarray([s[ImageStatsKeys.CHANNELS] for s in stats], dtype=np.float64)),
            ImageStatsKeys.SPACING: sample_op.evaluate(spacings),
            ImageStatsKeys.INTENSITY: self.summary_op.evaluate(intensity),
        }


class FgImageStatsSumm(Analyzer):
    """The cases' ``FgImageStats`` summarised."""

    def __init__(self, stats_name: str = DataStatsKeys.FG_IMAGE_STATS, average: bool = True):
        super().__init__(stats_name, {})
        self.summary_op = SummaryOperations()

    def __call__(self, data: list) -> dict:
        stats = [d[self.stats_name] for d in data]
        keys = stats[0][ImageStatsKeys.INTENSITY][0].keys()
        intensity = {k: np.asarray([s[ImageStatsKeys.INTENSITY][0][k] for s in stats]) for k in keys}
        return {ImageStatsKeys.INTENSITY: self.summary_op.evaluate(intensity)}


class LabelStatsSumm(Analyzer):
    """The cases' ``LabelStats`` summarised: every label, and each one's mean voxel share."""

    def __init__(self, stats_name: str = DataStatsKeys.LABEL_STATS, average: bool = True, do_ccp: bool = True):
        super().__init__(stats_name, {})
        self.summary_op = SummaryOperations()

    def __call__(self, data: list) -> dict:
        stats = [d[self.stats_name] for d in data]
        all_uids = sorted({u for s in stats for u in s[LabelStatsKeys.LABEL_UID]})
        pct: dict = {}
        for s in stats:
            for entry in s[LabelStatsKeys.PIXEL_PCT]:
                for uid, p in entry.items():
                    pct.setdefault(uid, []).append(p)
        return {
            LabelStatsKeys.LABEL_UID: all_uids,
            LabelStatsKeys.PIXEL_PCT: [{u: float(np.mean(v))} for u, v in sorted(pct.items())],
        }


class FilenameStats(Analyzer):
    """A case's file name under ``key`` (its image's ``filename_or_obj``, or the string)."""

    def __init__(self, key: str | None, stats_name: str):
        super().__init__(stats_name, {})
        self.key = key

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        name = "None"
        if self.key and self.key in d:
            item = d[self.key]
            if isinstance(item, MetaImage):
                name = str(item.meta.get("filename_or_obj", "None"))
            elif isinstance(item, str):
                name = item
        d[self.stats_name] = name
        return d


class ImageHistogram(Analyzer):
    """Each channel's intensity histogram (``hist_bins`` bins, default 100, over
    ``hist_range``, default [-500, 500]; one of each for all channels or one a channel)."""

    def __init__(self, image_key: str, stats_name: str = DataStatsKeys.IMAGE_HISTOGRAM, hist_bins=None,
                 hist_range=None):
        self.image_key = image_key
        self.hist_bins = [100] if hist_bins is None else hist_bins if isinstance(hist_bins, list) else [hist_bins]
        self.hist_range = [-500, 500] if hist_range is None else hist_range
        super().__init__(stats_name, {"counts": None, "bin_edges": None})
        self.update_ops(ImageStatsKeys.HISTOGRAM, SampleOperations())
        if not all(isinstance(hr, list) for hr in self.hist_range):
            self.hist_range = [self.hist_range]
        if len(self.hist_bins) != len(self.hist_range):
            raise ValueError(f"Number of histogram bins ({len(self.hist_bins)}) and histogram ranges "
                             f"({len(self.hist_range)}) need to be the same!")
        for i, (_bins, _range) in enumerate(zip(self.hist_bins, self.hist_range)):
            if not isinstance(_bins, int) or _bins < 0:
                raise ValueError(f"Expected {i + 1}. hist_bins value to be positive integer but got {_bins}")
            if not isinstance(_range, list) or len(_range) != 2:
                raise ValueError(f"Expected {i + 1}. hist_range values to be list of length 2 but received {_range}")

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        ndas = _arr(d[self.image_key])
        nr_channels = ndas.shape[0]
        if len(self.hist_bins) == 1:
            self.hist_bins = nr_channels * self.hist_bins
        if len(self.hist_bins) != nr_channels:
            raise ValueError(f"There is a mismatch between the number of channels ({nr_channels}) "
                             f"and number histogram bins ({len(self.hist_bins)}).")
        if len(self.hist_range) == 1:
            self.hist_range = nr_channels * self.hist_range
        if len(self.hist_range) != nr_channels:
            raise ValueError(f"There is a mismatch between the number of channels ({nr_channels}) "
                             f"and histogram ranges ({len(self.hist_range)}).")
        reports = []
        for channel in range(nr_channels):
            counts, bin_edges = _histogram(ndas[channel], self.hist_bins[channel], self.hist_range[channel])
            reports.append({"counts": counts, "bin_edges": bin_edges})
        d[self.stats_name] = reports
        return d


class ImageHistogramSumm(Analyzer):
    """The cases' histograms summed channel by channel (their edges must agree)."""

    def __init__(self, stats_name: str = DataStatsKeys.IMAGE_HISTOGRAM, average: bool | None = True):
        self.summary_average = average
        super().__init__(stats_name, {ImageStatsKeys.HISTOGRAM: None})
        self.update_ops(ImageStatsKeys.HISTOGRAM, SummaryOperations())

    def __call__(self, data: list) -> dict:
        if not isinstance(data, list):
            raise ValueError(f"Callable {self.__class__} requires list inputs")
        if len(data) == 0:
            raise ValueError(f"Callable {self.__class__} input list is empty")
        if self.stats_name not in data[0]:
            raise KeyError(f"{self.stats_name} is not in input data")
        summ_histogram: list = []
        for d in data:
            if not summ_histogram:
                summ_histogram = d[self.stats_name]
                for k in range(len(summ_histogram)):
                    summ_histogram[k]["counts"] = np.array(summ_histogram[k]["counts"])
            else:
                for k in range(len(summ_histogram)):
                    summ_histogram[k]["counts"] += np.array(d[self.stats_name][k]["counts"])
                    if np.all(np.asarray(summ_histogram[k]["bin_edges"])
                              != np.asarray(d[self.stats_name][k]["bin_edges"])):
                        raise ValueError(f"bin edges are not consistent! {summ_histogram[k]['bin_edges']} "
                                         f"vs. {d[self.stats_name][k]['bin_edges']}")
        for k in range(len(summ_histogram)):
            summ_histogram[k]["counts"] = summ_histogram[k]["counts"].tolist()
        return {ImageStatsKeys.HISTOGRAM: summ_histogram}
