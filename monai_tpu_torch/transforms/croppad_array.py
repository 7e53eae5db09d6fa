"""Crops (counterpart of monai_tpu/transforms/croppad_array.py: ``Crop``,
``SpatialCrop``, ``CropForeground``, ``RandSpatialCrop`` and ``RandCropByPosNegLabel``).

A crop is an integer translation in the pending-operation algebra: data_new[x] =
data_old[x + offset] on the new shape, so it flushes as tier 1 of
``lazy_utils.apply_affine_to_data`` (a slice, on the data's device, with zeros where
the box reaches past the image), moves the affine by the offset, and inverts through
``InvertibleTransform.inverse``. ``CropForeground``'s crop and pad are one such
operation (the JAX package records a crop and then a pad)."""
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
    ``channel_indices``), widened by ``margin``, padding with zeros where that box reaches
    past the image (only where ``allow_smaller`` is off). The box is found where the image
    lies. The JAX package's ``k_divisible``, other pad modes and ``return_coords`` are not
    ported."""

    def __init__(self, select_fn: Callable = is_positive, channel_indices=None, margin: Sequence[int] | int = 0,
                 allow_smaller: bool = True, lazy: bool = False):
        super().__init__(lazy=lazy)
        self.select_fn = select_fn
        self.channel_indices = ensure_tuple(channel_indices) if channel_indices is not None else None
        self.margin = margin
        self.allow_smaller = allow_smaller

    @property
    def requires_current_data(self):
        return True

    def compute_bounding_box(self, img: Any) -> tuple[np.ndarray, np.ndarray]:
        box_start, box_end = generate_spatial_bounding_box(img, self.select_fn, self.channel_indices, self.margin,
                                                           self.allow_smaller)
        return np.asarray(box_start, dtype=np.int64), np.asarray(box_end, dtype=np.int64)

    def crop_pad(self, img: Any, box_start: np.ndarray, box_end: np.ndarray, lazy: bool | None = None):
        """The box [box_start, box_end), zeros outside the image."""
        return self._translate(img, [int(s) for s in box_start], [int(e - s) for s, e in zip(box_start, box_end)],
                               lazy, extra_info={"box_start": [int(s) for s in box_start],
                                                 "box_end": [int(e) for e in box_end]})

    def __call__(self, img: Any, lazy: bool | None = None):
        return self.crop_pad(img, *self.compute_bounding_box(img), lazy=lazy)


class RandCropByPosNegLabel(Randomizable, Transform):
    """``num_samples`` crops of ``spatial_size``, each centred on a foreground voxel of the
    label with probability pos / (pos + neg), else on a background voxel (of ``image``,
    where given, above ``image_threshold``); a list of crops, each with its
    ``patch_index`` in its meta."""

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

    def randomize(self, label, image=None) -> None:
        fg_indices, bg_indices = map_binary_to_indices(label, image, self.image_threshold)
        self.centers = generate_pos_neg_label_crop_centers(self.spatial_size, self.num_samples, self.pos_ratio,
                                                           label.shape[1:], fg_indices, bg_indices, self.R,
                                                           self.allow_smaller)

    def __call__(self, img: Any, label=None, image=None, randomize: bool = True, lazy: bool | None = None) -> list:
        if randomize:
            if label is None:
                raise ValueError("label must be provided.")
            self.randomize(label, image)
        results = []
        roi_size = fall_back_tuple(self.spatial_size, default=_spatial_shape(img))
        for i, center in enumerate(self.centers):
            cropped = SpatialCrop(center, roi_size)(img, lazy=self.lazy if lazy is None else lazy)
            if isinstance(cropped, MetaImage):
                cropped.meta["patch_index"] = i
            results.append(cropped)
        return results
