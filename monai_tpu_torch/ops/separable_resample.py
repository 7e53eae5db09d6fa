"""Separable (diagonal-affine) resample of a channel-first (C, Z, Y, X) float32 volume on
a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_resample.py::pallas_separable_resample_3d. Each
axis's ``interp_matrix`` goes to the kernel as a tap table (``interp_taps``): per output
row, the row's nonzero input indices and weights, padded to the widest row with weight 0
(at most 1, 2 or 4 taps for orders 0, 1 and 3). The kernel is
``csrc/separable_resample_3d.cu``; its header says what bounds it on the card and what
the design does about that. ``separable_resample_3d_plain`` is the dense three-
``tensordot`` form of ``ops/separable.py::separable_affine_resample``: the wrapper runs
it for tensors on the CPU, and it is the oracle the kernel is held to on the card. For a
CUDA tensor the wrapper launches the kernel or raises; it never falls back. Forward only.
"""
from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import numpy as np
import torch

from ._build import library
from .separable import interp_matrix, is_separable, separable_affine_resample

__all__ = ["interp_taps", "separable_resample_3d", "separable_resample_3d_plain", "taps_from_matrix"]

ORDERS = (0, 1, 3)
BOUNDS = ("zeros", "border", "reflection")


def taps_from_matrix(W: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n_out, T) int32 input indices and float32 weights of the nonzeros of each row of
    ``W``, in ascending index order, T the most any row has (at least 1); short rows are
    padded with their first index (0 for an empty row) and weight 0, so adding the
    weights at the indices rebuilds ``W`` exactly."""
    nz = W != 0
    taps = max(1, int(nz.sum(axis=1).max(initial=0)))
    rank = np.cumsum(nz, axis=1) - 1  # position of each nonzero within its row
    idx = np.zeros((W.shape[0], taps), dtype=np.int32)
    w = np.zeros((W.shape[0], taps), dtype=np.float32)
    rows, cols = np.nonzero(nz)
    idx[rows, rank[rows, cols]] = cols
    w[rows, rank[rows, cols]] = W[rows, cols]
    counts = nz.sum(axis=1)
    for t in range(1, taps):
        short = counts <= t
        idx[short, t] = idx[short, 0]
    return idx, w


@functools.lru_cache(maxsize=512)
def interp_taps(n_in: int, n_out: int, scale: float, offset: float, order: int, bound: str,
                align_corners: bool = False) -> tuple[np.ndarray, np.ndarray] | None:
    """The tap table of ``interp_matrix(...)``, or None where that matrix is the identity."""
    W = interp_matrix(n_in, n_out, scale, offset, order, bound, align_corners)
    if n_in == n_out and np.array_equal(W, np.eye(n_in, dtype=np.float32)):
        return None
    idx, w = taps_from_matrix(W)
    idx.flags.writeable = w.flags.writeable = False
    return idx, w


@functools.lru_cache(maxsize=128)
def _device_taps(key: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, int] | None:
    """``interp_taps(*key)`` on ``device``, kept there: a path resamples with the same
    tables volume after volume."""
    taps = interp_taps(*key)
    if taps is None:
        return None
    idx, w = taps
    return (torch.from_numpy(idx.copy()).to(device), torch.from_numpy(w.copy()).to(device), idx.shape[1])


def _axis_keys(in_shape: Sequence[int], matrix: np.ndarray, out_shape: Sequence[int], order: int, bound: str,
               align_corners: bool) -> list[tuple]:
    m = np.asarray(matrix, dtype=np.float64)
    return [(int(in_shape[d]), int(out_shape[d]), float(m[d, d]), float(m[d, 3]), order, bound, bool(align_corners))
            for d in range(3)]


def separable_resample_3d_plain(img: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], order: int = 1,
                                bound: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Plain-PyTorch version: three dense float32 ``tensordot``s, axis 1, 2, then 3."""
    return separable_affine_resample(img, matrix, out_shape, order, bound, align_corners)


def _check(img: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], order: int, bound: str) -> None:
    if not isinstance(img, torch.Tensor) or img.ndim != 4:
        raise ValueError(f"separable_resample_3d takes a (C, Z, Y, X) tensor; got "
                         f"{tuple(img.shape) if isinstance(img, torch.Tensor) else type(img)}")
    if img.dtype != torch.float32:
        raise TypeError(f"separable_resample_3d takes float32; got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("separable_resample_3d takes a contiguous tensor")
    m = np.asarray(matrix, dtype=np.float64)
    if m.shape != (4, 4) or not is_separable(m):
        raise ValueError(f"separable_resample_3d takes a diagonal (4, 4) affine; got {m.tolist()}")
    if len(out_shape) != 3 or any(int(s) <= 0 for s in out_shape) or min(img.shape) <= 0:
        raise ValueError(f"separable_resample_3d needs 3 positive output sizes and a non-empty input; got "
                         f"{tuple(out_shape)} from {tuple(img.shape)}")
    if order not in ORDERS or bound not in BOUNDS:
        raise ValueError(f"separable_resample_3d takes orders {ORDERS} and bounds {BOUNDS}; got {order}, {bound!r}")
    if torch.is_grad_enabled() and img.requires_grad:
        raise RuntimeError("separable_resample_3d is forward-only; run it under torch.inference_mode()")


@functools.cache
def _launcher():
    fn = library().monai_separable_resample_3d
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def separable_resample_3d(img: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], order: int = 1,
                          bound: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Resample contiguous float32 ``img`` (C, Z, Y, X) by a diagonal (4, 4) affine that
    maps output voxels to input voxels, to (C, *out_shape) float32; orders 0, 1 and 3,
    bounds zeros, border and reflection, as ``interp_matrix`` builds them.

    CPU tensors run the plain version; CUDA tensors run the CUDA kernel (one pass per
    axis whose matrix is not the identity) and add one to ``separable_resample_3d.launches``."""
    _check(img, matrix, out_shape, order, bound)
    if img.device.type == "cpu":
        return separable_resample_3d_plain(img, matrix, out_shape, order, bound, align_corners)
    if img.device.type != "cuda":
        raise ValueError(f"separable_resample_3d runs on CPU or CUDA tensors, not {img.device}")
    c, zin, yin, xin = (int(s) for s in img.shape)
    zout, yout, xout = (int(s) for s in out_shape)
    tables = [_device_taps(key, img.device)
              for key in _axis_keys(img.shape[1:], matrix, out_shape, order, bound, align_corners)]
    out = torch.empty((c, zout, yout, xout), dtype=torch.float32, device=img.device)
    z_on, y_on, x_on = (t is not None for t in tables)
    tmp1 = torch.empty((c, zout, yin, xin), dtype=torch.float32, device=img.device) if z_on and (y_on or x_on) else None
    tmp2 = torch.empty((c, zout, yout, xin), dtype=torch.float32, device=img.device) if y_on and x_on else None
    args = []
    for t in tables:
        args += [None, None, 0] if t is None else [t[0].data_ptr(), t[1].data_ptr(), t[2]]
    with torch.cuda.device(img.device):
        err = _launcher()(img.data_ptr(), out.data_ptr(), None if tmp1 is None else tmp1.data_ptr(),
                          None if tmp2 is None else tmp2.data_ptr(), c, zin, yin, xin, zout, yout, xout, *args,
                          torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"separable_resample_3d: CUDA launch failed with error {err} "
                           f"({tuple(img.shape)} -> {tuple(out_shape)}, order {order}, bound {bound})")
    separable_resample_3d.launches += 1
    return out


separable_resample_3d.launches = 0
