"""Spatial transforms: Spacing, Orientation, Flip, Rotate90 and their random forms
RandFlip and RandRotate90 (counterpart of monai_tpu/transforms/spatial_array.py).

Each transform describes its action as a float64 output-to-input voxel matrix, pushes it
as a pending operation, and (not lazy) flushes it at once through
``lazy_executor.apply_pending``, which resamples on the data's device and moves the
affine: Orientation, a flip and a 90-degree rotation are integer permutations and flips,
Spacing a diagonal affine that runs the separable resample kernel. They invert through
``InvertibleTransform.inverse``. The random forms draw from their ``R`` as the JAX
package's do; a skipped one returns its input and records nothing.
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
from .transform import LazyTransform, RandomizableTransform
from .utils import map_spatial_axes

__all__ = ["Flip", "Orientation", "RandFlip", "RandRotate90", "Rotate90", "Spacing"]


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


def _spatial_shape(img: Any) -> tuple:
    return img.peek_pending_shape() if isinstance(img, MetaImage) else tuple(img.shape[1:])


class Flip(_SpatialLazyTransform):
    """Flip along ``spatial_axis`` (None: every spatial axis)."""

    def __init__(self, spatial_axis: Sequence[int] | int | None = None, lazy: bool = False):
        super().__init__(lazy=lazy)
        self.spatial_axis = spatial_axis

    def __call__(self, img: Any, lazy: bool | None = None):
        spatial_shape = _spatial_shape(img)
        sr = len(spatial_shape)
        matrix = np.eye(sr + 1, dtype=np.float64)
        for ax in map_spatial_axes(sr + 1, self.spatial_axis):
            matrix[ax - 1, ax - 1] = -1.0
            matrix[ax - 1, sr] = float(spatial_shape[ax - 1] - 1)
        return self._op(img, matrix, tuple(spatial_shape), mode="nearest", padding_mode="zeros", lazy=lazy)


class Rotate90(_SpatialLazyTransform):
    """Rotate by 90 degrees ``k`` times in the plane of ``spatial_axes``."""

    def __init__(self, k: int = 1, spatial_axes: tuple[int, int] = (0, 1), lazy: bool = False):
        super().__init__(lazy=lazy)
        self.k = (4 + (k % 4)) % 4
        self.spatial_axes = ensure_tuple(spatial_axes)
        if len(self.spatial_axes) != 2:
            raise ValueError(f"spatial_axes must be 2 numbers to define the plane, got {self.spatial_axes}.")

    def __call__(self, img: Any, lazy: bool | None = None):
        img = MetaImage.ensure_meta(img)
        shape = list(img.peek_pending_shape())
        sr = len(shape)
        a, b = (ax % sr for ax in self.spatial_axes)
        total = np.eye(sr + 1, dtype=np.float64)
        for _ in range(self.k):  # one turn in plane (a, b): out[x_a, x_b] = in[x_b, n_b - 1 - x_a]
            m = np.eye(sr + 1, dtype=np.float64)
            m[a, a] = m[b, b] = 0.0
            m[a, b], m[b, a] = 1.0, -1.0
            m[b, sr] = float(shape[b] - 1)
            total = total @ m
            shape[a], shape[b] = shape[b], shape[a]
        return self._op(img, total, tuple(shape), mode="nearest", padding_mode="zeros", lazy=lazy,
                        extra_info={"k": self.k, "axes": [a, b]})


class RandFlip(RandomizableTransform, LazyTransform):
    """With probability ``prob``, ``Flip(spatial_axis)``."""

    def __init__(self, prob: float = 0.1, spatial_axis: Sequence[int] | int | None = None, lazy: bool = False):
        RandomizableTransform.__init__(self, prob)
        LazyTransform.__init__(self, lazy=lazy)
        self.flipper = Flip(spatial_axis=spatial_axis)

    def __call__(self, img: Any, randomize: bool = True, lazy: bool | None = None):
        if randomize:
            self.randomize(None)
        if not self._do_transform:
            return img
        return self.flipper(img, lazy=self.lazy if lazy is None else lazy)


class RandRotate90(RandomizableTransform, LazyTransform):
    """With probability ``prob``, ``Rotate90`` by k in 1..``max_k`` turns, k drawn after
    the probability."""

    def __init__(self, prob: float = 0.1, max_k: int = 3, spatial_axes: tuple[int, int] = (0, 1),
                 lazy: bool = False):
        RandomizableTransform.__init__(self, prob)
        LazyTransform.__init__(self, lazy=lazy)
        self.max_k = max_k
        self.spatial_axes = spatial_axes
        self._rand_k = 0

    def randomize(self, data: Any = None) -> None:
        super().randomize(None)
        if self._do_transform:
            self._rand_k = self.R.randint(self.max_k) + 1

    def __call__(self, img: Any, randomize: bool = True, lazy: bool | None = None):
        if randomize:
            self.randomize()
        if not self._do_transform:
            return img
        return Rotate90(self._rand_k, self.spatial_axes)(img, lazy=self.lazy if lazy is None else lazy)
