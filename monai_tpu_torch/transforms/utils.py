"""Helpers of the crop transforms (counterpart of the same functions in
monai_tpu/transforms/utils.py): the foreground bounding box, the foreground and
background voxel indices of a label, and the random crop centers drawn from them. The
centers are the JAX package's own numpy arithmetic on the host, with the same draws from
the same ``RandomState``, so one seed gives the same centers in both packages."""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch

from ..data.meta_image import MetaImage
from ..utils.backend import to_numpy
from ..utils.misc import ensure_tuple, ensure_tuple_rep, fall_back_tuple

__all__ = ["correct_crop_centers", "generate_pos_neg_label_crop_centers", "generate_spatial_bounding_box",
           "is_positive", "map_binary_to_indices", "map_spatial_axes"]


def is_positive(img):
    return img > 0


def _data(x: Any):
    return x.data if isinstance(x, MetaImage) else x


def generate_spatial_bounding_box(img: Any, select_fn: Callable = is_positive, channel_indices=None,
                                  margin: Sequence[int] | int = 0,
                                  allow_smaller: bool = True) -> tuple[list[int], list[int]]:
    """The [start, end) of each spatial dim that holds voxels where ``select_fn`` is true
    in any channel (of ``channel_indices``), widened by ``margin`` (and clipped to the
    image where ``allow_smaller``); (0, 0) along a dim with none. The selection runs where
    the image lies; only its projection on each axis comes to the host."""
    arr = _data(img)
    spatial_size = tuple(arr.shape[1:])
    margin = ensure_tuple_rep(margin, len(spatial_size))
    if any(m < 0 for m in margin):
        raise ValueError(f"margin value should not be negative, got {margin}.")
    sel = select_fn(arr[list(ensure_tuple(channel_indices))] if channel_indices is not None else arr)
    sel = torch.as_tensor(sel).any(dim=0)
    box_start, box_end = [], []
    for di in range(sel.ndim):
        axes = tuple(d for d in range(sel.ndim) if d != di)
        hits = np.where(to_numpy(sel.any(dim=axes) if axes else sel))[0]
        if hits.size == 0:
            box_start.append(0)
            box_end.append(0)
            continue
        min_d, max_d = hits[0] - margin[di], hits[-1] + margin[di] + 1
        if allow_smaller:
            min_d, max_d = max(min_d, 0), min(max_d, spatial_size[di])
        box_start.append(int(min_d))
        box_end.append(int(max_d))
    return box_start, box_end


def map_spatial_axes(img_ndim: int, spatial_axes=None, channel_first: bool = True) -> list[int]:
    """Spatial axis numbers as array axes (past the channel axis where ``channel_first``);
    None means every spatial axis."""
    if spatial_axes is None:
        return list(range(1, img_ndim) if channel_first else range(img_ndim - 1))
    axes = []
    for a in ensure_tuple(spatial_axes):
        if channel_first:
            axes.append(a % img_ndim if a < 0 else a + 1)
        else:
            axes.append((a - 1) % (img_ndim - 1) if a < 0 else a)
    return axes


def correct_crop_centers(centers: list, spatial_size: Sequence[int] | int, label_spatial_shape: Sequence[int],
                         allow_smaller: bool = False) -> list[int]:
    """``centers`` moved so that a crop of ``spatial_size`` around them lies inside
    ``label_spatial_shape``; raises where the crop is larger than the image unless
    ``allow_smaller``."""
    spatial_size = fall_back_tuple(spatial_size, default=label_spatial_shape)
    if any(np.subtract(label_spatial_shape, spatial_size) < 0):
        if not allow_smaller:
            raise ValueError(f"The size of the proposed random crop ROI {spatial_size} is larger than the image size "
                             f"{label_spatial_shape}.")
        spatial_size = tuple(min(l, s) for l, s in zip(label_spatial_shape, spatial_size))
    valid_start = np.floor_divide(spatial_size, 2)
    valid_end = np.subtract(np.add(label_spatial_shape, 1), np.ceil(np.divide(spatial_size, 2)).astype(int))
    for i, valid_s in enumerate(valid_start):
        if valid_s == valid_end[i]:
            valid_end[i] += 1
    return [min(max(int(c), int(v_s)), int(v_e) - 1) for c, v_s, v_e in zip(centers, valid_start, valid_end)]


def generate_pos_neg_label_crop_centers(spatial_size, num_samples: int, pos_ratio: float,
                                        label_spatial_shape: Sequence[int], fg_indices, bg_indices,
                                        rand_state: np.random.RandomState | None = None,
                                        allow_smaller: bool = False) -> list[list[int]]:
    """``num_samples`` crop centers: each a foreground voxel with probability
    ``pos_ratio``, else a background one (two draws from ``rand_state`` a sample: the
    choice, then the voxel), moved inside the image."""
    if rand_state is None:
        rand_state = np.random.random.__self__  # type: ignore
    fg_indices, bg_indices = np.asarray(fg_indices), np.asarray(bg_indices)
    if len(fg_indices) == 0 and len(bg_indices) == 0:
        raise ValueError("No sampling location available.")
    if len(fg_indices) == 0 or len(bg_indices) == 0:
        pos_ratio = 0 if len(fg_indices) == 0 else 1
    centers = []
    for _ in range(num_samples):
        indices_to_use = fg_indices if rand_state.rand() < pos_ratio else bg_indices
        idx = indices_to_use[rand_state.randint(len(indices_to_use))]
        center = np.unravel_index(idx, label_spatial_shape)
        centers.append(correct_crop_centers(list(center), spatial_size, label_spatial_shape, allow_smaller))
    return centers


def map_binary_to_indices(label: Any, image: Any = None, image_threshold: float = 0.0):
    """The flat indices of the foreground voxels (nonzero in any channel of ``label``)
    and of the background ones (where ``image`` is given, only those above
    ``image_threshold`` in some channel), as numpy arrays on the host."""
    label_flat = to_numpy(torch.as_tensor(_data(label)).bool().any(dim=0)).ravel()
    fg_indices = np.nonzero(label_flat)[0]
    if image is not None:
        img_flat = to_numpy((torch.as_tensor(_data(image)) > image_threshold).any(dim=0)).ravel()
        bg_indices = np.nonzero(img_flat & ~label_flat)[0]
    else:
        bg_indices = np.nonzero(~label_flat)[0]
    return fg_indices, bg_indices
