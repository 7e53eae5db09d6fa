"""Enumerations (the subset of monai_tpu/utils/enums.py that the port uses)."""
from __future__ import annotations

from enum import Enum

__all__ = ["StrEnum", "AlgoKeys", "BlendMode", "CommonKeys", "DataStatsKeys", "GridSampleMode", "GridSamplePadMode",
           "ImageStatsKeys", "LabelStatsKeys", "LazyAttr", "LossReduction", "MetaKeys", "MetricReduction", "SpaceKeys",
           "TraceKeys"]


class StrEnum(str, Enum):
    """Enum whose members are also strings (``str(Member) == value``)."""

    def __str__(self) -> str:
        return self.value

    def __repr__(self) -> str:
        return self.value


class BlendMode(StrEnum):
    """Sliding-window blending."""

    CONSTANT = "constant"
    GAUSSIAN = "gaussian"


class GridSampleMode(StrEnum):
    """Interpolation modes for grid resampling."""

    NEAREST = "nearest"
    BILINEAR = "bilinear"
    BICUBIC = "bicubic"


class GridSamplePadMode(StrEnum):
    """Padding modes for grid resampling."""

    ZEROS = "zeros"
    BORDER = "border"
    REFLECTION = "reflection"


class TraceKeys(StrEnum):
    """Keys of the applied and pending operation records."""

    CLASS_NAME = "class"
    ID = "id"
    ORIG_SIZE = "orig_size"
    EXTRA_INFO = "extra_info"
    AFFINE = "affine"


class MetaKeys(StrEnum):
    """Keys of a MetaImage's ``meta`` dict."""

    AFFINE = "affine"
    ORIGINAL_AFFINE = "original_affine"
    SPATIAL_SHAPE = "spatial_shape"
    SPACE = "space"
    ORIGINAL_CHANNEL_DIM = "original_channel_dim"
    FILENAME_OR_OBJ = "filename_or_obj"


class SpaceKeys(StrEnum):
    """Coordinate-system conventions."""

    RAS = "RAS"


class LazyAttr(StrEnum):
    """Keys of a pending operation dict."""

    SHAPE = "lazy_shape"
    AFFINE = "lazy_affine"
    PADDING_MODE = "lazy_padding_mode"
    INTERP_MODE = "lazy_interpolation_mode"
    ALIGN_CORNERS = "lazy_align_corners"
    DTYPE = "lazy_dtype"


class CommonKeys(StrEnum):
    """Engine batch and output keys."""

    IMAGE = "image"
    LABEL = "label"
    PRED = "pred"
    LOSS = "loss"
    METADATA = "metadata"


class LossReduction(StrEnum):
    NONE = "none"
    MEAN = "mean"
    SUM = "sum"


class MetricReduction(StrEnum):
    NONE = "none"
    MEAN = "mean"
    SUM = "sum"
    MEAN_BATCH = "mean_batch"
    SUM_BATCH = "sum_batch"
    MEAN_CHANNEL = "mean_channel"
    SUM_CHANNEL = "sum_channel"


class CompInitMode(StrEnum):
    """How a bundle config's ``_mode_`` instantiates a ``_target_``."""

    DEFAULT = "default"
    CALLABLE = "callable"
    DEBUG = "debug"
    PARTIAL = "partial"


class AlgoKeys(StrEnum):
    """The keys of an Auto3DSeg history record (``apps.auto3dseg``)."""

    ID = "identifier"
    ALGO = "algo_instance"
    IS_TRAINED = "is_trained"
    SCORE = "best_metric"


class DataStatsKeys(StrEnum):
    """The sections of an Auto3DSeg data report (``auto3dseg.SegSummarizer``)."""

    SUMMARY = "stats_summary"
    BY_CASE = "stats_by_cases"
    BY_CASE_IMAGE_PATH = "image_filepath"
    BY_CASE_LABEL_PATH = "label_filepath"
    IMAGE_STATS = "image_stats"
    FG_IMAGE_STATS = "image_foreground_stats"
    LABEL_STATS = "label_stats"
    IMAGE_HISTOGRAM = "image_histogram"


class ImageStatsKeys(StrEnum):
    """The keys of an image's statistics."""

    SHAPE = "shape"
    CHANNELS = "channels"
    CROPPED_SHAPE = "cropped_shape"
    SPACING = "spacing"
    SIZEMM = "sizemm"
    INTENSITY = "intensity"
    HISTOGRAM = "histogram"


class LabelStatsKeys(StrEnum):
    """The keys of a label map's statistics."""

    LABEL_UID = "labels"
    PIXEL_PCT = "foreground_percentage"
    IMAGE_INTST = "image_intensity"
    LABEL = "label"
    LABEL_SHAPE = "shape"
    LABEL_NCOMP = "ncomponents"
