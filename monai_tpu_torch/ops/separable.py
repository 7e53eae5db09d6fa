"""Separable (axis-aligned) affine resampling (counterpart of monai_tpu/ops/separable.py).

A diagonal affine, as Spacing, Resize and Zoom make, factorises into one 1-D
interpolation per spatial axis: out = W_1 · (W_2 · (W_3 · x)), each ``W`` an
(n_out, n_in) weight matrix built on the host by ``interp_matrix``.
``separable_affine_resample`` is the plain PyTorch form, three dense float32
``tensordot``s (axis 1, then 2, then 3, as the JAX package contracts them); the CUDA
kernel ``ops/separable_resample.py`` computes the same function from the matrices'
nonzero taps.
"""
from __future__ import annotations

from collections.abc import Sequence
from functools import lru_cache

import numpy as np
import torch

__all__ = ["interp_matrix", "is_separable", "separable_affine_resample"]


def _cubic_w(t: np.ndarray) -> list[np.ndarray]:
    a = -0.75
    d0, d1, d2, d3 = 1.0 + t, t, 1.0 - t, 2.0 - t

    def w_near(d):
        return ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0

    def w_far(d):
        return ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a

    return [w_far(d0), w_near(d1), w_near(d2), w_far(d3)]


def _reflect(c: np.ndarray, n_in: int, align_corners: bool) -> np.ndarray:
    """A continuous coordinate reflected into [0, n_in - 1]."""
    if align_corners:
        period = 2.0 * (n_in - 1)
        c = np.remainder(c, period)
        return np.where(c >= n_in - 1, period - c, c)
    period = 2.0 * n_in
    c = np.remainder(c + 0.5, period)
    return np.where(c >= n_in, period - c, c) - 0.5


@lru_cache(maxsize=512)
def interp_matrix(n_in: int, n_out: int, scale: float, offset: float, order: int, bound: str,
                  align_corners: bool = False) -> np.ndarray:
    """Dense (n_out, n_in) float32 1-D interpolation matrix for in_coord = scale * out + offset
    (float64 coordinates), orders 0, 1 and 3, bounds zeros, border and reflection. Taps
    that a bound folds onto one input index are summed. Cached, and read-only."""
    coords = scale * np.arange(n_out, dtype=np.float64) + offset
    W = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)

    def place(idx, w):
        """Add weight w at input index idx, after the bound."""
        if bound == "zeros":
            valid = (idx >= 0) & (idx <= n_in - 1)
            idx = np.clip(idx, 0, n_in - 1)
            w = w * valid
        elif bound == "border":
            idx = np.clip(idx, 0, n_in - 1)
        else:  # reflection
            if n_in == 1:
                idx = np.zeros_like(idx)
            elif align_corners:
                period = 2 * (n_in - 1)
                idx = np.remainder(idx, period)
                idx = np.where(idx >= n_in - 1, period - idx, idx)
            else:
                period = 2 * n_in
                idx = np.remainder(idx, period)
                idx = np.where(idx >= n_in, period - 1 - idx, idx)
            idx = np.clip(idx, 0, n_in - 1)
        np.add.at(W, (rows, idx.astype(np.int64)), w.astype(np.float32))

    if order == 0:
        c = coords
        if bound == "border":
            c = np.clip(coords, 0.0, n_in - 1)
        elif bound == "reflection":  # reflect the continuous coordinate first
            c = np.clip(_reflect(coords, n_in, align_corners) if n_in > 1 else coords, 0.0, n_in - 1)
        r = np.floor(c + 0.5)
        valid = ((r >= 0) & (r <= n_in - 1)) if bound == "zeros" else np.ones(n_out, dtype=bool)
        np.add.at(W, (rows, np.clip(r, 0, n_in - 1).astype(np.int64)), valid.astype(np.float32))
    elif order == 1:
        c = coords
        if bound == "border":
            c = np.clip(c, 0.0, n_in - 1)
        elif bound == "reflection" and n_in > 1:
            c = _reflect(c, n_in, align_corners)
            if not align_corners:
                c = np.clip(c, 0.0, n_in - 1)
        f = np.floor(c)
        t = c - f
        place(f.astype(np.int64), 1.0 - t)
        place(f.astype(np.int64) + 1, t)
    elif order == 3:
        f = np.floor(coords)
        for k, w in zip((-1, 0, 1, 2), _cubic_w(coords - f)):
            place(f.astype(np.int64) + k, w)
    else:
        raise ValueError(f"unsupported order {order}")
    W.flags.writeable = False
    return W


def is_separable(matrix: np.ndarray, atol: float = 1e-6) -> bool:
    """True if the linear part is diagonal (axis-aligned scaling, no rotation or shear)."""
    m = np.asarray(matrix, dtype=np.float64)
    d = m.shape[0] - 1
    lin = m[:d, :d]
    return bool(np.all(np.abs(lin - np.diag(np.diag(lin))) <= atol) and np.allclose(m[d, :d], 0, atol=atol)
                and np.isclose(m[d, d], 1, atol=atol))


def separable_affine_resample(img: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], order: int = 1,
                              bound: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Resample channel-first ``img`` (C, *spatial) by a diagonal affine (output voxel to
    input voxel) with one dense float32 ``tensordot`` per spatial axis, in axis order.
    A floating input keeps its dtype; any other comes out float32."""
    m = np.asarray(matrix, dtype=np.float64)
    nd = len(out_shape)
    x = img.float()
    for d in range(nd):
        W = interp_matrix(int(img.shape[1 + d]), int(out_shape[d]), float(m[d, d]), float(m[d, nd]), order, bound,
                          align_corners)
        x = torch.movedim(torch.tensordot(torch.from_numpy(W.copy()).to(x.device), x, dims=([1], [d + 1])), 0, d + 1)
    return x.to(img.dtype) if img.dtype.is_floating_point else x
