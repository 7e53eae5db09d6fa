"""Spatial transforms, Spacing and Orientation (counterpart of
monai_tpu/transforms/spatial_array.py).

Each transform describes its action as a float64 output-to-input voxel matrix, pushes it
as a pending operation, and (not lazy) flushes it at once through
``lazy_executor.apply_pending``, which resamples on the data's device: Orientation is an
integer permutation and flip, Spacing a diagonal affine that runs the separable
resample kernel. Both invert through ``InvertibleTransform.inverse``.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np

from ..data.affine_utils import (affine_to_spacing, axcodes2ornt, compute_shape_offset, inv_ornt_aff,
                                 io_orientation, ornt_transform, to_affine_nd, zoom_affine)
from ..data.meta_image import MetaImage
from ..utils.enums import GridSampleMode, GridSamplePadMode
from ..utils.misc import ensure_tuple
from .inverse import InvertibleTransform
from .lazy_executor import apply_pending
from .lazy_utils import apply_affine_to_data, resolve_mode
from .transform import LazyTransform

__all__ = ["Spacing", "Orientation"]


def resolves_modes(interp_mode, padding_mode) -> tuple[int, str]:
    """(spline order, padding mode name) from a transform's mode arguments."""
    pm = "zeros" if padding_mode is None else str(padding_mode)
    pm = {"constant": "zeros", "edge": "border", "replicate": "border", "reflect": "reflection",
          "mirror": "reflection"}.get(pm, pm)
    return resolve_mode(1 if interp_mode is None else interp_mode), pm


class _SpatialLazyTransform(InvertibleTransform, LazyTransform):
    """Push a pending affine operation; flush it unless lazy."""

    def __init__(self, lazy: bool = False):
        LazyTransform.__init__(self, lazy=lazy)

    def _op(self, img: Any, matrix: np.ndarray, sp_size: Sequence[int], mode=None, padding_mode=None,
            align_corners=None, lazy: bool | None = None, extra_info: dict | None = None):
        lazy_ = self.lazy if lazy is None else lazy
        m, pm = resolves_modes(mode, padding_mode)
        if not isinstance(img, MetaImage):  # a bare tensor: resample at once, no trace
            return apply_affine_to_data(img, matrix, sp_size, mode=m, padding_mode=pm,
                                        align_corners=bool(align_corners))
        img = img.new_like(img.data)  # never change the caller's image
        self.push_transform(img, matrix, sp_size, img.peek_pending_shape(), extra_info or {}, mode=m,
                            padding_mode=pm, align_corners=align_corners)
        return img if lazy_ else apply_pending(img)[0]


class Spacing(_SpatialLazyTransform):
    """Resample to a new voxel spacing ``pixdim`` (the output's float32 where the input's
    is: the JAX package's default float64 ``dtype`` held float32 values that the next
    transform cast back, so the port keeps them in float32)."""

    def __init__(self, pixdim, mode=GridSampleMode.BILINEAR, padding_mode=GridSamplePadMode.BORDER,
                 align_corners: bool = False, lazy: bool = False):
        super().__init__(lazy=lazy)
        self.pixdim = np.array(ensure_tuple(pixdim), dtype=np.float64)
        self.mode, self.padding_mode, self.align_corners = mode, padding_mode, align_corners

    def __call__(self, img: Any, mode=None, padding_mode=None, align_corners=None, lazy: bool | None = None):
        img = MetaImage.ensure_meta(img)
        original_spatial_shape = img.peek_pending_shape()
        sr = len(original_spatial_shape)
        if sr <= 0:
            raise ValueError(f"data has no spatial dimensions, shape {img.shape}")
        affine_ = to_affine_nd(sr, img.peek_pending_affine())
        out_d = self.pixdim[:sr].copy()
        if out_d.size < sr:
            out_d = np.append(out_d, [out_d[-1]] * (sr - out_d.size))
        orig_d = affine_to_spacing(affine_, sr)
        out_d = np.where(out_d > 0, out_d, orig_d)  # a spacing of 0 or less keeps the input's
        new_affine = zoom_affine(affine_, out_d, diagonal=False)
        output_shape, offset = compute_shape_offset(original_spatial_shape, affine_, new_affine)
        new_affine[:sr, -1] = offset[:sr]
        M = np.linalg.solve(affine_, new_affine)
        return self._op(img, M, tuple(int(s) for s in output_shape), mode=mode or self.mode,
                        padding_mode=padding_mode or self.padding_mode,
                        align_corners=self.align_corners if align_corners is None else align_corners,
                        lazy=lazy, extra_info={"pixdim": out_d.tolist()})


class Orientation(_SpatialLazyTransform):
    """Reorient to axis codes such as "RAS": an integer permutation and flip."""

    def __init__(self, axcodes: str, lazy: bool = False):
        super().__init__(lazy=lazy)
        self.axcodes = axcodes

    def __call__(self, img: Any, lazy: bool | None = None):
        img = MetaImage.ensure_meta(img)
        spatial_shape = img.peek_pending_shape()
        sr = len(spatial_shape)
        if sr not in (2, 3):
            raise ValueError(f"Orientation expects 2D/3D data, got spatial rank {sr}")
        affine_ = to_affine_nd(sr, img.peek_pending_affine())
        dst = axcodes2ornt(self.axcodes[:sr])
        if len(dst) < sr:
            raise ValueError(f"axcodes must match data shape, got axcodes={len(dst)}D, data={sr}D")
        spatial_ornt = ornt_transform(io_orientation(affine_), dst)
        out_shape = [0] * sr
        for in_ax, (out_ax, _flip) in enumerate(spatial_ornt):
            out_shape[int(out_ax)] = int(spatial_shape[in_ax])
        return self._op(img, inv_ornt_aff(spatial_ornt, spatial_shape), tuple(out_shape), mode="nearest",
                        padding_mode="zeros", lazy=lazy, extra_info={"original_affine": affine_.tolist()})
