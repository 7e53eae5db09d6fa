"""Pending-operation algebra and the resample dispatch (counterpart of
monai_tpu/transforms/lazy_utils.py).

A pending operation is a dict keyed by ``LazyAttr``: ``lazy_affine``, the (D+1, D+1)
float64 matrix M with data_new[x] = data_old[M @ x] (output voxel to input voxel; the
image affine becomes A @ M), ``lazy_shape``, the output spatial shape, and the resample
settings. Applying op 1 then op 2 is one operation with matrix M1 @ M2.

``apply_affine_to_data`` runs on the data's device, in one of three tiers:

1. an integer signed permutation with an integer shift (Orientation, flips, crops and
   pads): permute, slice, pad and flip, with no arithmetic;
2. a diagonal affine (Spacing, Resize, Zoom) at order 0, 1 or 3: the separable resample,
   ``ops/separable_resample.py``, on the card's kernel for a CUDA tensor and its plain
   version for a CPU tensor; a 2-D image runs as a depth-1 volume;
3. any other affine (Rotate, a shear): ``ops.resample.affine_resample``, the gather of
   ``grid_pull`` at any spline order, on the data's device.

The JAX package's host path for numpy float32 arrays (a C++ library of its own) has no
counterpart: the port's data are tensors on their device.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resample import affine_resample, resolve_mode
from ..ops.separable import is_separable
from ..ops.separable_resample import separable_resample_3d
from ..utils.backend import get_torch_dtype
from ..utils.enums import LazyAttr

__all__ = ["pending_op", "affine_from_pending", "kwargs_from_pending", "is_compatible_apply_kwargs",
           "combine_transforms", "requires_interp", "apply_affine_to_data", "resample", "resolve_mode"]

_BOUNDS = ("zeros", "border", "reflection")
# the padding of tier 1 and of Zoom's eager pad, as torch's F.pad modes
PAD_MODES = {"zeros": "constant", "constant": "constant", "border": "replicate", "edge": "replicate",
             "replicate": "replicate", "reflection": "reflect", "reflect": "reflect", "wrap": "circular",
             "circular": "circular"}


def pending_op(matrix: np.ndarray, shape: Sequence[int], mode: Any = None, padding_mode: Any = None,
               align_corners: bool | None = None, dtype: Any = None) -> dict:
    """A pending-operation record; ``dtype`` is the type its resample's output is cast to."""
    op = {LazyAttr.AFFINE: np.asarray(matrix, dtype=np.float64), LazyAttr.SHAPE: tuple(int(s) for s in shape)}
    for key, value in ((LazyAttr.INTERP_MODE, mode), (LazyAttr.PADDING_MODE, padding_mode),
                       (LazyAttr.ALIGN_CORNERS, align_corners), (LazyAttr.DTYPE, dtype)):
        if value is not None:
            op[key] = value
    return op


def affine_from_pending(pending_item: Any) -> np.ndarray:
    if isinstance(pending_item, dict):
        return np.asarray(pending_item[LazyAttr.AFFINE], dtype=np.float64)
    return np.asarray(pending_item, dtype=np.float64)


def kwargs_from_pending(pending_item: dict) -> dict:
    """The resample settings of a pending operation, with its output shape."""
    if not isinstance(pending_item, dict):
        return {}
    keys = (LazyAttr.INTERP_MODE, LazyAttr.PADDING_MODE, LazyAttr.ALIGN_CORNERS, LazyAttr.DTYPE, LazyAttr.SHAPE)
    return {k: pending_item[k] for k in keys if k in pending_item}


def is_compatible_apply_kwargs(kwargs_1: dict, kwargs_2: dict) -> bool:
    """Whether two pending operations can fuse into one resample: their interpolation,
    padding, corner alignment and output type agree where both set them."""
    for k in (LazyAttr.INTERP_MODE, LazyAttr.PADDING_MODE, LazyAttr.ALIGN_CORNERS, LazyAttr.DTYPE):
        v1, v2 = kwargs_1.get(k), kwargs_2.get(k)
        if v1 is not None and v2 is not None and v1 != v2:
            return False
    return True


def combine_transforms(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Two pending affines as one (``left`` applied first): L @ R."""
    return affine_from_pending(left) @ affine_from_pending(right)


def requires_interp(matrix: np.ndarray, atol: float = 1e-5):
    """For a signed integer permutation with an integer shift, the (input axis, sign,
    input offset) of each output axis; else None."""
    m = np.asarray(matrix, dtype=np.float64)
    d = m.shape[0] - 1
    if not np.allclose(m[d, :d], 0, atol=atol) or not np.isclose(m[d, d], 1, atol=atol):
        return None
    t = m[:d, d]
    if not np.allclose(t, np.round(t), atol=atol):
        return None
    desc, used_in = [], set()
    for out_ax in range(d):
        nz = np.where(np.abs(m[:d, out_ax]) > atol)[0]
        if len(nz) != 1 or int(nz[0]) in used_in:
            return None
        in_ax = int(nz[0])
        used_in.add(in_ax)
        s = m[in_ax, out_ax]
        if not np.isclose(abs(s), 1, atol=atol):
            return None
        desc.append((in_ax, int(np.sign(s)), float(np.round(t[in_ax]))))
    return desc


def _apply_integer_affine(data: torch.Tensor, desc, out_shape: tuple, padding_mode: str) -> torch.Tensor:
    """data_new[x] = data_old[sign * x + offset] axis by axis: permute, slice, pad, flip."""
    d = len(desc)
    x = data.permute(0, *[desc[out_ax][0] + 1 for out_ax in range(d)])
    pads, slicer = [], [slice(None)]
    for out_ax, (_, sign, off) in enumerate(desc):
        n_in, n_out = x.shape[out_ax + 1], int(out_shape[out_ax])
        u0, u1 = (int(off), int(off) + n_out) if sign > 0 else (int(off) - n_out + 1, int(off) + 1)
        lo_pad, hi_pad, s0, s1 = max(0, -u0), max(0, u1 - n_in), max(0, u0), min(n_in, u1)
        if s1 < s0:
            s0 = s1 = 0
            lo_pad, hi_pad = n_out, 0
        pads.append((lo_pad, hi_pad))
        slicer.append(slice(s0, s1))
    x = x[tuple(slicer)]
    if any(lo or hi for lo, hi in pads):
        mode = PAD_MODES.get(str(padding_mode))
        if mode is None:
            raise NotImplementedError(f"padding mode {padding_mode!r} is not ported; "
                                      f"the port pads with {sorted(PAD_MODES)}")
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad lists the last axis first
        x = F.pad(x, flat) if mode == "constant" else F.pad(x[None], flat, mode=mode)[0]
    flip_axes = [out_ax + 1 for out_ax in range(d) if desc[out_ax][1] < 0]
    if flip_axes:
        x = torch.flip(x, flip_axes)
    return x.contiguous()


def _separable(data: torch.Tensor, m: np.ndarray, out_shape: tuple, order: int, bound: str,
               align_corners: bool) -> torch.Tensor:
    nd = len(out_shape)
    if nd not in (2, 3):
        raise NotImplementedError(f"the separable resample takes 2-D and 3-D images, not {nd}-D")
    x = data.float().contiguous()
    if nd == 2:  # a depth-1 volume: the depth axis's matrix is the identity, and its pass is skipped
        x = x[:, None]
        m3 = np.eye(4)
        m3[1:3, 1:3] = m[:2, :2]
        m3[1:3, 3] = m[:2, 2]
        m, out_shape = m3, (1, *out_shape)
    out = separable_resample_3d(x, m, out_shape, order, bound, align_corners)
    if nd == 2:
        out = out[:, 0]
    return out.to(data.dtype) if data.dtype.is_floating_point else out


def apply_affine_to_data(data: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], mode: Any = 1,
                         padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Apply an output-to-input voxel affine to channel-first ``data``, on its device.
    A floating input keeps its dtype; any other comes out float32 where it is resampled."""
    out_shape = tuple(int(s) for s in out_shape)
    desc = requires_interp(matrix)
    if desc is not None:
        return _apply_integer_affine(data, desc, out_shape, padding_mode)
    m = np.asarray(matrix, dtype=np.float64)
    bound = padding_mode if padding_mode in _BOUNDS else "zeros"
    order = resolve_mode(mode)
    if m.shape[0] - 1 == len(out_shape) and is_separable(m) and order in (0, 1, 3):
        return _separable(data, m, out_shape, order, bound, align_corners)
    x = data if data.dtype.is_floating_point else data.float()
    return affine_resample(x, m, out_shape, mode=order, padding_mode=bound, align_corners=align_corners)


def resample(data: torch.Tensor, matrix: np.ndarray, kwargs: dict | None = None) -> torch.Tensor:
    """Resample ``data`` by a pending operation's matrix and settings, the output cast to
    its ``dtype`` where it has one."""
    kwargs = kwargs or {}
    mode = kwargs.get(LazyAttr.INTERP_MODE)
    padding_mode = kwargs.get(LazyAttr.PADDING_MODE)
    out = apply_affine_to_data(data, matrix, kwargs.get(LazyAttr.SHAPE, data.shape[1:]),
                               mode=1 if mode is None else mode,
                               padding_mode="zeros" if padding_mode is None else padding_mode,
                               align_corners=bool(kwargs.get(LazyAttr.ALIGN_CORNERS) or False))
    dtype = kwargs.get(LazyAttr.DTYPE)
    return out if dtype is None else out.to(get_torch_dtype(dtype))
