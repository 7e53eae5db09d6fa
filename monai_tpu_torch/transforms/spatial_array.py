"""Spatial transforms: Spacing, Orientation, Flip, Rotate90, Rotate, Zoom and the random
forms RandFlip, RandRotate90, RandRotate and RandZoom (counterpart of
monai_tpu/transforms/spatial_array.py).

Each transform describes its action as a float64 output-to-input voxel matrix, pushes it
as a pending operation, and (not lazy) flushes it at once through
``lazy_executor.apply_pending``, which resamples on the data's device and moves the
affine: Orientation, a flip and a 90-degree rotation are integer permutations and flips,
Spacing and Zoom diagonal affines that run the separable resample kernel, Rotate a
general affine (``ops.resample.affine_resample``). They invert through
``InvertibleTransform.inverse``. The random forms draw from their ``R`` as the JAX
package's do; a skipped one returns its input and records nothing.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np
import torch.nn.functional as F

from ..data.affine_utils import (affine_to_spacing, axcodes2ornt, compute_shape_offset, inv_ornt_aff,
                                 io_orientation, ornt_transform, to_affine_nd, zoom_affine)
from ..data.meta_image import MetaImage
from ..utils.enums import GridSampleMode, GridSamplePadMode
from ..utils.misc import ensure_tuple, ensure_tuple_rep
from .inverse import InvertibleTransform
from .lazy_executor import apply_pending, promote_pending_with_data
from .lazy_utils import PAD_MODES, apply_affine_to_data, resolve_mode
from .transform import LazyTransform, RandomizableTransform
from .utils import create_rotate, create_translate, map_spatial_axes

__all__ = ["Flip", "Orientation", "RandFlip", "RandRotate", "RandRotate90", "RandZoom", "Rotate", "Rotate90", "Spacing",
           "Zoom"]


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


class Rotate(_SpatialLazyTransform):
    """Rotate a 2-D or 3-D image by ``angle`` (radians; three for 3-D, about axes 0, 1, 2)
    about its centre. The pull matrix is c_in @ rot @ c_out, the centres' shifts about the
    rotation, so the content turns by -angle in index space. ``keep_size=False`` grows the
    output to hold the rotated corners."""

    def __init__(self, angle: Sequence[float] | float, keep_size: bool = True, mode=GridSampleMode.BILINEAR,
                 padding_mode=GridSamplePadMode.BORDER, align_corners: bool = False, lazy: bool = False):
        super().__init__(lazy=lazy)
        self.angle = angle
        self.keep_size = keep_size
        self.mode, self.padding_mode, self.align_corners = mode, padding_mode, align_corners

    def __call__(self, img: Any, mode=None, padding_mode=None, align_corners=None, lazy: bool | None = None):
        in_shape = _spatial_shape(img)
        sr = len(in_shape)
        if sr not in (2, 3):
            raise ValueError(f"Rotate supports 2D/3D, got {sr}D")
        angle = ensure_tuple_rep(self.angle, 1 if sr == 2 else 3)
        rot = create_rotate(sr, angle)
        if self.keep_size:
            out_size = tuple(in_shape)
        else:
            corners = np.asarray(np.meshgrid(*[(0, dim) for dim in in_shape], indexing="ij")).reshape((sr, -1))
            corners = rot[:-1, :-1] @ corners
            out_size = tuple(int(v) for v in np.asarray(np.ptp(corners, axis=1) + 0.5, dtype=int))
        c_in = create_translate(sr, [(n - 1) / 2.0 for n in in_shape])
        c_out = create_translate(sr, [-(n - 1) / 2.0 for n in out_size])
        return self._op(img, c_in @ rot @ c_out, out_size, mode=mode or self.mode,
                        padding_mode=padding_mode or self.padding_mode,
                        align_corners=self.align_corners if align_corners is None else align_corners, lazy=lazy,
                        extra_info={"angle": list(ensure_tuple(angle))})


class RandRotate(RandomizableTransform, LazyTransform):
    """With probability ``prob``, ``Rotate`` by angles drawn uniformly from ``range_x``,
    ``range_y`` and ``range_z`` (a pair, or ±a number); 2-D takes the x angle. The three
    angles are drawn after the probability, x first."""

    def __init__(self, range_x=0.0, range_y=0.0, range_z=0.0, prob: float = 0.1, keep_size: bool = True,
                 mode=GridSampleMode.BILINEAR, padding_mode=GridSamplePadMode.BORDER, align_corners: bool = False,
                 lazy: bool = False):
        RandomizableTransform.__init__(self, prob)
        LazyTransform.__init__(self, lazy=lazy)
        self.range_x, self.range_y, self.range_z = (_symmetric_range(r) for r in (range_x, range_y, range_z))
        self.keep_size = keep_size
        self.mode, self.padding_mode, self.align_corners = mode, padding_mode, align_corners
        self.x = self.y = self.z = 0.0

    def randomize(self, data: Any = None) -> None:
        super().randomize(None)
        if self._do_transform:
            self.x = self.R.uniform(low=self.range_x[0], high=self.range_x[1])
            self.y = self.R.uniform(low=self.range_y[0], high=self.range_y[1])
            self.z = self.R.uniform(low=self.range_z[0], high=self.range_z[1])

    def __call__(self, img: Any, randomize: bool = True, lazy: bool | None = None):
        if randomize:
            self.randomize()
        if not self._do_transform:
            return img
        ndim = len(_spatial_shape(img))
        rotator = Rotate(self.x if ndim == 2 else (self.x, self.y, self.z), keep_size=self.keep_size, mode=self.mode,
                         padding_mode=self.padding_mode, align_corners=self.align_corners)
        return rotator(img, lazy=self.lazy if lazy is None else lazy)


def _symmetric_range(r) -> tuple:
    r = ensure_tuple(r)
    return tuple(sorted([-r[0], r[0]])) if len(r) == 1 else r


class Zoom(_SpatialLazyTransform):
    """Zoom by ``zoom`` (one factor, or one an axis). The image is resampled to
    floor(in * z) voxels an axis (half-pixel grid, or corners with ``align_corners``);
    ``keep_size`` then pads (``padding_mode``, np.pad's names: "edge" replicates) or
    centre-crops it back to the input's shape. Eagerly that is the resample, at the border
    bound, and a pad or crop of the array, as the reference's interpolate and
    ResizeWithPadOrCrop; lazily one composed affine, which differs from it in the padded
    band. Nearest zooms index floor(y * s), torch's legacy nearest."""

    def __init__(self, zoom: Sequence[float] | float, mode=GridSampleMode.BILINEAR, padding_mode="edge",
                 align_corners: bool = False, keep_size: bool = True, lazy: bool = False):
        super().__init__(lazy=lazy)
        self.zoom = zoom
        self.mode, self.padding_mode, self.align_corners = mode, padding_mode, align_corners
        self.keep_size = keep_size

    def __call__(self, img: Any, mode=None, padding_mode=None, align_corners=None, lazy: bool | None = None):
        in_shape = _spatial_shape(img)
        sr = len(in_shape)
        z = ensure_tuple_rep(self.zoom, sr)
        zoomed = tuple(int(np.floor(float(n) * zi)) for n, zi in zip(in_shape, z))
        ac = self.align_corners if align_corners is None else align_corners
        mode_ = mode or self.mode
        pm = padding_mode or self.padding_mode
        nearest = str(mode_) == "nearest"
        m = np.eye(sr + 1, dtype=np.float64)  # the composed pull: resample, then pad or crop
        mz = np.eye(sr + 1, dtype=np.float64)  # the eager resample to the zoomed size
        for d in range(sr):
            if ac:
                s_d, off = (in_shape[d] - 1.0) / max(zoomed[d] - 1.0, 1.0), 0.0
            else:
                s_d = in_shape[d] / zoomed[d]
                off = (s_d - 1.0) / 2.0
            if self.keep_size and zoomed[d] < in_shape[d]:
                t_d = -((in_shape[d] - zoomed[d]) // 2)  # the pad's left width
            elif self.keep_size and zoomed[d] > in_shape[d]:
                t_d = (zoomed[d] // 2) - (in_shape[d] // 2)  # the crop's start
            else:
                t_d = 0
            m[d, d], m[d, sr] = s_d, s_d * t_d + off
            mz[d, d], mz[d, sr] = s_d, off
            if nearest:  # floor(y * s) by rounding; the eps dodges half-to-even ties
                mz[d, d], mz[d, sr] = in_shape[d] / zoomed[d], -0.5 + 1e-4
        out_size = tuple(in_shape) if self.keep_size else zoomed
        lazy_ = self.lazy if lazy is None else lazy
        pending = isinstance(img, MetaImage) and bool(img.pending_operations)
        resized = self.keep_size and zoomed != tuple(in_shape)
        if lazy_ or pending or not (resized or nearest):
            return self._op(img, m, out_size, mode=mode_, padding_mode=pm, align_corners=ac, lazy=lazy,
                            extra_info={"zoom": list(z)})
        order, pm_ = resolves_modes(mode_, pm)
        data = img.data if isinstance(img, MetaImage) else img
        if resized:  # resample to the zoomed size, then centre-crop or pad back
            dat = apply_affine_to_data(data, mz, zoomed, mode=order, padding_mode="border", align_corners=bool(ac))
            slices, pads = [slice(None)], []
            for d in range(sr):
                if zoomed[d] > in_shape[d]:
                    start = (zoomed[d] // 2) - (in_shape[d] // 2)
                    slices.append(slice(start, start + in_shape[d]))
                    pads.append((0, 0))
                else:
                    w = in_shape[d] - zoomed[d]
                    slices.append(slice(None))
                    pads.append((w // 2, w - w // 2))
            dat = dat[tuple(slices)]
            if any(lo or hi for lo, hi in pads):
                pad_mode = PAD_MODES.get(str(pm), "replicate")  # an unknown mode pads at the edge, as the JAX Zoom
                flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad lists the last axis first
                dat = F.pad(dat, flat) if pad_mode == "constant" else F.pad(dat[None], flat, mode=pad_mode)[0]
            dat = dat.contiguous()
        else:  # nearest at the zoomed size, or at the input's where the zoom keeps it
            dat = apply_affine_to_data(data, mz, out_size, mode=order, padding_mode=pm_, align_corners=bool(ac))
        if not isinstance(img, MetaImage):
            return dat
        tracked = img.new_like(img.data)
        self.push_transform(tracked, m, out_size, in_shape, {"zoom": list(z)}, mode=order, padding_mode=pm_,
                            align_corners=ac)
        return promote_pending_with_data(tracked, dat)


class RandZoom(RandomizableTransform, LazyTransform):
    """With probability ``prob``, ``Zoom`` by factors drawn uniformly between ``min_zoom``
    and ``max_zoom`` (one, or one an axis; two on 3-D data: the first for the first two
    axes), after the probability."""

    def __init__(self, prob: float = 0.1, min_zoom=0.9, max_zoom=1.1, mode=GridSampleMode.BILINEAR,
                 padding_mode="edge", align_corners: bool = False, keep_size: bool = True, lazy: bool = False):
        RandomizableTransform.__init__(self, prob)
        LazyTransform.__init__(self, lazy=lazy)
        self.min_zoom, self.max_zoom = ensure_tuple(min_zoom), ensure_tuple(max_zoom)
        if len(self.min_zoom) != len(self.max_zoom):
            raise ValueError(f"min_zoom and max_zoom must have same length, got {min_zoom} and {max_zoom}.")
        self.mode, self.padding_mode, self.align_corners = mode, padding_mode, align_corners
        self.keep_size = keep_size
        self._zoom: Sequence[float] = (1.0,)

    def randomize(self, img: Any) -> None:
        super().randomize(None)
        if not self._do_transform:
            return
        self._zoom = [self.R.uniform(lo, hi) for lo, hi in zip(self.min_zoom, self.max_zoom)]
        ndim = len(img.shape) - 1
        if len(self._zoom) == 1:
            self._zoom = ensure_tuple_rep(self._zoom[0], ndim)
        elif len(self._zoom) == 2 and ndim > 2:
            self._zoom = ensure_tuple_rep(self._zoom[0], ndim - 1) + ensure_tuple(self._zoom[-1])

    def __call__(self, img: Any, randomize: bool = True, lazy: bool | None = None):
        if randomize:
            self.randomize(img)
        if not self._do_transform:
            return img
        zoomer = Zoom(self._zoom, mode=self.mode, padding_mode=self.padding_mode, align_corners=self.align_corners,
                      keep_size=self.keep_size)
        return zoomer(img, lazy=self.lazy if lazy is None else lazy)
