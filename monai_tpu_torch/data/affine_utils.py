"""Affine and orientation math for N-D medical images (counterpart of
monai_tpu/data/affine_utils.py, the functions the spleen inference path uses).

numpy float64 on the host: an image's affine never goes to the card.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np

__all__ = ["to_affine_nd", "affine_to_spacing", "compute_shape_offset", "zoom_affine", "io_orientation",
           "axcodes2ornt", "ornt_transform", "inv_ornt_aff"]


def to_affine_nd(r: int | np.ndarray, affine: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Embed/crop ``affine`` into an (r+1, r+1) homogeneous matrix.

    Semantics match monai/data/utils.py:1008: copy the top-left rotation/zoom block and
    the translation column; identity elsewhere.
    """
    affine_np = np.asarray(affine, dtype=dtype)
    if affine_np.ndim != 2:
        raise ValueError(f"affine must be 2-D, got {affine_np.ndim}-D")
    new_affine = np.asarray(r, dtype=dtype)
    if new_affine.ndim == 0:
        sr = int(new_affine.item())
        if not np.isfinite(sr) or sr < 0:
            raise ValueError(f"r must be positive, got {sr}.")
        new_affine = np.eye(sr + 1, dtype=dtype)
    d = max(min(len(new_affine) - 1, len(affine_np) - 1), 1)
    new_affine[:d, :d] = affine_np[:d, :d]
    if d > 1:
        new_affine[:d, -1] = affine_np[:d, -1]
    return new_affine


def affine_to_spacing(affine: np.ndarray, r: int = 3, dtype=np.float64, suppress_zeros: bool = True) -> np.ndarray:
    """Column-norm voxel spacing from an affine (reference: monai/data/utils.py:737)."""
    affine = np.asarray(affine, dtype=np.float64)
    if r > affine.shape[1] - 1:
        r = affine.shape[1] - 1
    spacing = np.sqrt(np.sum(affine[:affine.shape[0] - 1, :r] ** 2, axis=0))
    if suppress_zeros:
        spacing[spacing == 0] = 1.0
    return spacing.astype(dtype)


def compute_shape_offset(spatial_shape: Sequence[int], in_affine: np.ndarray, out_affine: np.ndarray,
                         scale_extent: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Output shape and offset so the output FOV covers the input FOV
    (reference: monai/data/utils.py:868).

    Returns (out_shape[int], offset[float]) where offset is applied to out_affine's
    translation column.
    """
    shape = np.array(spatial_shape, copy=True, dtype=float)
    sr = len(shape)
    in_affine_ = to_affine_nd(sr, np.asarray(in_affine, dtype=np.float64))
    out_affine_ = to_affine_nd(sr, np.asarray(out_affine, dtype=np.float64))
    in_coords = [(-0.5, dim - 0.5) if scale_extent else (0.0, dim - 1.0) for dim in shape]
    corners: np.ndarray = np.asarray(np.meshgrid(*in_coords, indexing="ij")).reshape((len(shape), -1))
    corners = np.concatenate((corners, np.ones_like(corners[:1])))
    try:
        corners_out = np.linalg.solve(out_affine_, in_affine_) @ corners
    except np.linalg.LinAlgError as e:
        raise ValueError(f"Affine {out_affine_} is not invertible") from e
    corners_world = in_affine_ @ corners
    all_dist = corners_out[:-1].copy()
    corners_out = corners_out[:-1] / corners_out[-1]
    out_shape = np.round(np.ptp(corners_out, axis=1)) if scale_extent else np.round(np.ptp(corners_out, axis=1) + 1.0)
    offset = None
    for i in range(corners.shape[1]):
        min_corner = np.min(all_dist - all_dist[:, i:i + 1], axis=1)
        if np.allclose(min_corner, 0.0, rtol=1e-3):
            # this corner has the smallest out-voxel coords: shift it to the origin
            offset = corners_world[:-1, i]
            break
    if offset is None:  # no single minimal corner: align the image centres instead
        offset = (in_affine_[:-1, :-1] @ (shape / 2.0) + in_affine_[:-1, -1]
                  - out_affine_[:-1, :-1] @ (out_shape / 2.0))
    if scale_extent:
        in_offset = np.append(0.5 * (shape / out_shape - 1.0), 1.0)
        offset = np.abs((in_affine_ @ in_offset / in_offset[-1])[:-1]) * np.sign(offset)
    return out_shape.astype(int, copy=False), offset


def zoom_affine(affine: np.ndarray, scale: Sequence[float], diagonal: bool = True) -> np.ndarray:
    """Rescale an affine's column norms to ``scale`` (reference: monai/data/utils.py:808)."""
    affine = np.asarray(affine, dtype=np.float64, order="A")
    if len(affine) != len(affine[0]):
        raise ValueError(f"affine must be square, got {affine.shape}.")
    scale_np = np.asarray(scale, dtype=np.float64)
    d = len(affine) - 1
    if len(scale_np) < d:
        norm = affine_to_spacing(affine, r=d)
        scale_np = np.append(scale_np, norm[len(scale_np):])
    scale_np = scale_np[:d]
    scale_np[scale_np == 0] = 1.0
    if diagonal:
        return np.diag(np.append(scale_np, [1.0]))
    rzs = affine[:-1, :-1]  # rotation zoom scale
    zs = np.linalg.cholesky(rzs.T @ rzs).T
    rotation = rzs @ np.linalg.inv(zs)
    s = np.sign(np.diag(zs)) * np.abs(scale_np)
    # construct new affine with rotation and zoom
    new_affine = affine.copy()
    new_affine[:-1, :-1] = rotation @ np.diag(s)
    new_affine[:-1, -1] = 0.0
    return new_affine


def io_orientation(affine: np.ndarray, tol: float | None = None) -> np.ndarray:
    """Orientation of the input axes in terms of output axes for ``affine``.

    Returns an (n, 2) array where row p is (out_axis, direction) for input axis p;
    direction is +1/-1; unmatchable axes are (nan, nan).  Same contract as
    ``nibabel.io_orientation`` (re-derived: SVD-based best-matching assignment).
    """
    affine = np.asarray(affine, dtype=np.float64)
    q, p = affine.shape[0] - 1, affine.shape[1] - 1
    rzs = affine[:q, :p]
    # normalize columns
    zooms = np.sqrt(np.sum(rzs * rzs, axis=0))
    zooms[zooms == 0] = 1
    rs = rzs / zooms
    # greedy assignment by largest |cosine| via SVD-orthogonalized matrix
    P, S, Qs = np.linalg.svd(rs, full_matrices=False)
    if tol is None:
        tol = S.max() * max(rs.shape) * np.finfo(S.dtype).eps
    keep = S > tol
    R = P[:, keep] @ Qs[keep]
    ornt = np.ones((p, 2), dtype=np.float64) * np.nan
    for _ in range(p):
        # find the largest remaining |R| entry
        if not np.any(np.isfinite(R)) or np.all(np.abs(np.nan_to_num(R)) < 1e-12):
            break
        flat_idx = int(np.nanargmax(np.abs(np.nan_to_num(R))))
        out_ax, in_ax = np.unravel_index(flat_idx, R.shape)
        if abs(R[out_ax, in_ax]) < 1e-12:
            break
        ornt[in_ax, 0] = out_ax
        ornt[in_ax, 1] = 1.0 if R[out_ax, in_ax] > 0 else -1.0
        R[out_ax, :] = np.nan
        R[:, in_ax] = np.nan
    return ornt


def axcodes2ornt(axcodes: Sequence[str], labels=None) -> np.ndarray:
    """Convert axis codes like ('R','A','S') to an orientation array."""
    labels = labels or (("L", "R"), ("P", "A"), ("I", "S"))
    n_axes = len(axcodes)
    ornt = np.ones((n_axes, 2), dtype=np.float64) * np.nan
    for code_idx, code in enumerate(axcodes):
        if code is None:
            continue
        for label_idx, codes in enumerate(labels):
            if code == codes[0]:
                ornt[code_idx, :] = [label_idx, -1]
                break
            if code == codes[1]:
                ornt[code_idx, :] = [label_idx, 1]
                break
        else:
            raise ValueError(f"axcode {code!r} not in labels {labels}")
    return ornt


def ornt_transform(start_ornt: np.ndarray, end_ornt: np.ndarray) -> np.ndarray:
    """Orientation transform taking ``start_ornt`` to ``end_ornt``."""
    start_ornt = np.asarray(start_ornt)
    end_ornt = np.asarray(end_ornt)
    if start_ornt.shape != end_ornt.shape:
        raise ValueError("start_ornt and end_ornt must have the same shape")
    result = np.empty_like(start_ornt)
    for end_in_idx, (end_out_idx, end_flip) in enumerate(end_ornt):
        for start_in_idx, (start_out_idx, start_flip) in enumerate(start_ornt):
            if end_out_idx == start_out_idx:
                if start_flip == end_flip:
                    flip = 1
                else:
                    flip = -1
                result[start_in_idx, :] = [end_in_idx, flip]
                break
        else:
            raise ValueError(f"Unable to find out axis {end_out_idx} in start_ornt")
    return result


def inv_ornt_aff(ornt: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Affine undoing the effect of applying ``ornt`` to an array of ``shape``."""
    ornt = np.asarray(ornt)
    if np.any(np.isnan(ornt)):
        raise ValueError("cannot invert an orientation with NaN entries")
    p = ornt.shape[0]
    shape = np.array(shape)[:p]
    # orntreverses: undo_reorder maps new axis positions back
    axis_transpose = [int(v) for v in ornt[:, 0]]
    undo_reorder = np.eye(p + 1)[axis_transpose + [p], :]
    undo_flip = np.diag(list(ornt[:, 1]) + [1.0])
    center_trans = -(shape - 1) / 2.0
    undo_flip[:p, p] = (ornt[:, 1] * center_trans) - center_trans
    return undo_flip @ undo_reorder
