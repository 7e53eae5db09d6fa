"""Crops (counterpart of monai_tpu/transforms/croppad_array.py: ``Crop``,
``SpatialCrop``, ``CropForeground``, ``RandSpatialCrop`` and ``RandCropByPosNegLabel``).

A crop is an integer translation in the pending-operation algebra: data_new[x] =
data_old[x + offset] on the new shape, so it flushes as tier 1 of
``lazy_utils.apply_affine_to_data`` (a slice, on the data's device, with zeros where
the box reaches past the image), moves the affine by the offset, and inverts through
``InvertibleTransform.inverse``. ``CropForeground``'s crop and pad are one such
operation (the JAX package records a crop and then a pad). ``RandCropByPosNegLabel``
draws from the flat foreground and background indices that ``utility_array.FgBgToIndices``
gives, where they are passed."""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import numpy as np

from ..data.meta_image import MetaImage
from ..utils.misc import ensure_tuple, ensure_tuple_rep, fall_back_tuple
from .spatial_array import _SpatialLazyTransform
from .transform import Randomizable, Transform
from .utils import generate_pos_neg_label_crop_centers, generate_spatial_bounding_box, is_positive, map_binary_to_indices

__all__ = ["Crop", "SpatialCrop", "CropForeground", "RandCropByPosNegLabel", "RandSpatialCrop"]


def _spatial_shape(img: Any) -> tuple:
    return img.peek_pending_shape() if isinstance(img, MetaImage) else tuple(img.shape[1:])


class Crop(_SpatialLazyTransform):
    """Crop by a list of slices (steps of 1), as Python slicing cuts: a slice never
    reaches past the image."""

    def _translate(self, img: Any, offset: Sequence[int], out_size: Sequence[int], lazy: bool | None,
                   extra_info: dict | None = None):
        sr = len(out_size)
        matrix = np.eye(sr + 1, dtype=np.float64)
        matrix[:sr, sr] = np.asarray(offset, dtype=np.float64)
        return self._op(img, matrix, tuple(int(s) for s in out_size), mode="nearest", padding_mode="zeros",
                        lazy=lazy, extra_info=extra_info)

    def __call__(self, img: Any, slices: Sequence[slice] = (), lazy: bool | None = None):
        spatial_shape = _spatial_shape(img)
        slices_ = list(slices) + [slice(None)] * (len(spatial_shape) - len(slices))
        offset, out_size = [], []
        for n, s in zip(spatial_shape, slices_):
            start = 0 if s.start is None else (s.start if s.start >= 0 else s.start + n)
            stop = n if s.stop is None else (s.stop if s.stop >= 0 else s.stop + n)
            start = min(max(start, 0), n)
            offset.append(int(start))
            out_size.append(int(min(max(stop, start), n) - start))
        return self._translate(img, offset, out_size, lazy)


class SpatialCrop(Crop):
    """Crop a box of ``roi_size`` around ``roi_center`` (its start at center - size // 2,
    clipped at 0)."""

    def __init__(self, roi_center: Sequence[int], roi_size: Sequence[int] | int, lazy: bool = False):
        super().__init__(lazy=lazy)
        center = np.asarray(roi_center, dtype=np.int64)
        size = np.asarray(ensure_tuple_rep(roi_size, len(center)))
        start = np.maximum(center - np.maximum(np.floor_divide(size, 2), 0), 0)
        self.slices = tuple(slice(int(a), int(b)) for a, b in zip(start, np.maximum(start + size, start)))

    def __call__(self, img: Any, lazy: bool | None = None):
        return super().__call__(img, slices=self.slices, lazy=lazy)


class RandSpatialCrop(Randomizable, Crop):
    """A crop of ``roi_size`` (its -1 or missing axes the image's) at a random start, or at
    the centre where ``random_center`` is off; with ``random_size`` each axis's size is
    drawn between ``roi_size`` and ``max_roi_size`` (the image's by default). The draws are
    the JAX package's, from ``R`` in its order: the sizes, then the starts."""

    def __init__(self, roi_size: Sequence[int] | int, max_roi_size=None, random_center: bool = True,
                 random_size: bool = False, lazy: bool = False):
        Crop.__init__(self, lazy=lazy)
        self.roi_size = roi_size
        self.max_roi_size = max_roi_size
        self.random_center = random_center
        self.random_size = random_size
        self._size: tuple[int, ...] | None = None
        self._slices: tuple[slice, ...] | None = None

    def randomize(self, img_size: Sequence[int]) -> None:
        self._size = fall_back_tuple(self.roi_size, img_size)
        if self.random_size:
            max_size = img_size if self.max_roi_size is None else fall_back_tuple(self.max_roi_size, img_size)
            if any(i > j for i, j in zip(self._size, max_size)):
                raise ValueError(f"min ROI size: {self._size} is larger than max ROI size: {max_size}.")
            self._size = tuple(self.R.randint(low=self._size[i], high=max_size[i] + 1) for i in range(len(img_size)))
        if self.random_center:
            starts = [self.R.randint(0, i - s + 1) for i, s in zip(img_size, self._size)]
            self._slices = tuple(slice(st, st + sz) for st, sz in zip(starts, self._size))

    def __call__(self, img: Any, randomize: bool = True, lazy: bool | None = None):
        img_size = _spatial_shape(img)
        if randomize:
            self.randomize(img_size)
        if self._size is None:
            raise RuntimeError("self._size not specified.")
        if self.random_center:
            return super().__call__(img, slices=self._slices, lazy=lazy)
        return SpatialCrop([i // 2 for i in img_size], self._size)(img, lazy=self.lazy if lazy is None else lazy)


class CropForeground(Crop):
    """Crop to the bounding box of the voxels where ``select_fn`` holds in any channel (of
    ``channel_indices``), widened by ``margin`` and grown about its centre to a multiple of
    ``k_divisible``, padding where that box reaches past the image (by ``mode``: "constant"
    zeros, "edge", "reflect" or "wrap", np.pad's names, or the resample's "zeros",
    "border", "reflection"). The box is found where the image lies. ``return_coords``
    returns the box's start and end beside the crop."""

    def __init__(self, select_fn: Callable = is_positive, channel_indices=None, margin: Sequence[int] | int = 0,
                 allow_smaller: bool = True, return_coords: bool = False, k_divisible: Sequence[int] | int = 1,
                 mode: str = "constant", lazy: bool = False, **pad_kwargs):
        super().__init__(lazy=lazy)
        self.select_fn = select_fn
        self.channel_indices = ensure_tuple(channel_indices) if channel_indices is not None else None
        self.margin = margin
        self.allow_smaller = allow_smaller
        self.return_coords = return_coords
        self.k_divisible = k_divisible
        self.mode = mode
        _check_pad_kwargs(pad_kwargs)

    @property
    def requires_current_data(self):
        return True

    def compute_bounding_box(self, img: Any) -> tuple[np.ndarray, np.ndarray]:
        box_start, box_end = generate_spatial_bounding_box(img, self.select_fn, self.channel_indices, self.margin,
                                                           self.allow_smaller)
        box_start, box_end = np.asarray(box_start, dtype=np.int64), np.asarray(box_end, dtype=np.int64)
        size = box_end - box_start
        k = np.asarray(fall_back_tuple(self.k_divisible, (1,) * len(size)), dtype=np.int64)
        grown = np.where(k > 0, -(-size // np.maximum(k, 1)) * k, size)  # the smallest multiple of k >= size
        box_start = box_start - (grown - size) // 2
        return box_start, box_start + grown

    def crop_pad(self, img: Any, box_start: np.ndarray, box_end: np.ndarray, mode=None, lazy: bool | None = None,
                 **pad_kwargs):
        """The box [box_start, box_end), padded by ``mode`` (default the transform's)
        outside the image."""
        _check_pad_kwargs(pad_kwargs)
        pad = PAD_NAMES.get(str(mode or self.mode))
        if pad is None:
            raise ValueError(f"CropForeground pads with {sorted(PAD_NAMES)}, not {mode or self.mode!r}")
        matrix = np.eye(len(box_start) + 1, dtype=np.float64)
        matrix[:-1, -1] = np.asarray(box_start, dtype=np.float64)
        return self._op(img, matrix, tuple(int(e - s) for s, e in zip(box_start, box_end)), mode="nearest",
                        padding_mode=pad, lazy=lazy,
                        extra_info={"box_start": [int(s) for s in box_start], "box_end": [int(e) for e in box_end]})

    def __call__(self, img: Any, mode=None, lazy: bool | None = None, **pad_kwargs):
        box_start, box_end = self.compute_bounding_box(img)
        cropped = self.crop_pad(img, box_start, box_end, mode, lazy=lazy, **pad_kwargs)
        return (cropped, box_start, box_end) if self.return_coords else cropped


# CropForeground's pad modes (np.pad's names and the resample's) as the padding modes of
# the tier-1 resample (``lazy_utils.PAD_MODES``)
PAD_NAMES = {"constant": "zeros", "zeros": "zeros", "edge": "border", "border": "border", "replicate": "border",
             "reflect": "reflection", "reflection": "reflection", "wrap": "circular", "circular": "circular"}


def _check_pad_kwargs(pad_kwargs: dict) -> None:
    """A constant pad is zeros: another ``constant_values`` (np.pad's) or ``value`` is refused."""
    value = pad_kwargs.get("constant_values", pad_kwargs.get("value", 0))
    if value != 0 or set(pad_kwargs) - {"constant_values", "value"}:
        raise ValueError(f"CropForeground pads a constant of 0 only, not {pad_kwargs}")


class RandCropByPosNegLabel(Randomizable, Transform):
    """``num_samples`` crops of ``spatial_size``, each centred on a foreground voxel of the
    label with probability pos / (pos + neg), else on a background voxel (of ``image``,
    where given, above ``image_threshold``); a list of crops, each with its
    ``patch_index`` in its meta. ``fg_indices`` and ``bg_indices``, where both are given
    (``FgBgToIndices``'s flat indices), stand in for the label's."""

    def __init__(self, spatial_size: Sequence[int] | int, pos: float = 1.0, neg: float = 1.0, num_samples: int = 1,
                 image_threshold: float = 0.0, allow_smaller: bool = False, lazy: bool = False):
        if pos < 0 or neg < 0:
            raise ValueError(f"pos and neg must be nonnegative, got pos={pos} neg={neg}.")
        if pos + neg == 0:
            raise ValueError("Incompatible values: pos=0 and neg=0.")
        self.spatial_size = spatial_size
        self.pos_ratio = pos / (pos + neg)
        self.num_samples = num_samples
        self.image_threshold = image_threshold
        self.allow_smaller = allow_smaller
        self.lazy = lazy
        self.centers: list = []

    def randomize(self, label, image=None, fg_indices=None, bg_indices=None) -> None:
        if fg_indices is None or bg_indices is None:
            fg_indices, bg_indices = map_binary_to_indices(label, image, self.image_threshold)
        self.centers = generate_pos_neg_label_crop_centers(self.spatial_size, self.num_samples, self.pos_ratio,
                                                           label.shape[1:], np.asarray(fg_indices),
                                                           np.asarray(bg_indices), self.R, self.allow_smaller)

    def __call__(self, img: Any, label=None, image=None, fg_indices=None, bg_indices=None, randomize: bool = True,
                 lazy: bool | None = None) -> list:
        if randomize:
            if label is None:
                raise ValueError("label must be provided.")
            self.randomize(label, image, fg_indices, bg_indices)
        results = []
        roi_size = fall_back_tuple(self.spatial_size, default=_spatial_shape(img))
        for i, center in enumerate(self.centers):
            cropped = SpatialCrop(center, roi_size)(img, lazy=self.lazy if lazy is None else lazy)
            if isinstance(cropped, MetaImage):
                cropped.meta["patch_index"] = i
            results.append(cropped)
        return results

