"""Enumerations (the subset of monai_tpu/utils/enums.py that the port uses)."""
from __future__ import annotations

from enum import Enum

__all__ = ["StrEnum", "BlendMode", "CommonKeys", "GridSampleMode", "GridSamplePadMode", "LazyAttr", "LossReduction",
           "MetaKeys", "MetricReduction", "SpaceKeys", "TraceKeys"]


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
