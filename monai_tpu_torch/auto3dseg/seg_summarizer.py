"""SegSummarizer (counterpart of monai_tpu/auto3dseg/seg_summarizer.py): a chain of case
analyzers, each paired with the summary analyzer of its reports."""
from __future__ import annotations

from typing import Any

from ..transforms.compose import Compose
from ..utils.enums import DataStatsKeys
from .analyzer import (FgImageStats, FgImageStatsSumm, FilenameStats, ImageHistogram, ImageHistogramSumm, ImageStats,
                       ImageStatsSumm, LabelStats, LabelStatsSumm)

__all__ = ["SegSummarizer"]


class SegSummarizer(Compose):
    """Called on a case's dict (its image and label loaded, on any device), adds each
    analyzer's report; ``summarize`` aggregates a list of such dicts. With ``label_key``
    None, no label analyzers; ``hist_bins`` other than 0 adds the histogram; with
    ``histogram_only`` only the file names and the histogram."""

    def __init__(self, image_key: str, label_key: str | None, average: bool = True, do_ccp: bool = True,
                 hist_bins=0, hist_range=None, histogram_only: bool = False):
        self.image_key = image_key
        self.label_key = label_key
        self.hist_bins = hist_bins
        self.hist_range = hist_range
        self.histogram_only = histogram_only
        self.summary_analyzers: list[Any] = []
        super().__init__()
        self.add_analyzer(FilenameStats(image_key, DataStatsKeys.BY_CASE_IMAGE_PATH), None)
        self.add_analyzer(FilenameStats(label_key, DataStatsKeys.BY_CASE_LABEL_PATH), None)
        if not histogram_only:
            self.add_analyzer(ImageStats(image_key), ImageStatsSumm(average=average))
            if label_key is not None:
                self.add_analyzer(FgImageStats(image_key, label_key), FgImageStatsSumm(average=average))
                self.add_analyzer(LabelStats(image_key, label_key, do_ccp=do_ccp),
                                  LabelStatsSumm(average=average, do_ccp=do_ccp))
        if hist_bins != 0:
            self.add_analyzer(ImageHistogram(image_key=image_key, hist_bins=hist_bins, hist_range=hist_range),
                              ImageHistogramSumm())

    def add_analyzer(self, case_analyzer, summary_analyzer) -> None:
        self.transforms = tuple(list(self.transforms) + [case_analyzer])
        if summary_analyzer is not None:
            self.summary_analyzers.append(summary_analyzer)

    def summarize(self, data: list[dict]) -> dict:
        if not isinstance(data, list):
            raise ValueError(f"{self.__class__} summarize function needs a list input.")
        if len(data) == 0:
            return {}
        return {analyzer.stats_name: analyzer(data) for analyzer in self.summary_analyzers}
