"""Patch grids and importance maps for sliding-window inference (counterpart of the
same functions in monai_tpu/data/utils.py). Host-side: the grid is Python ints, the
importance map is computed with numpy in float32 and handed over as a tensor."""
from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch

from ..utils.enums import BlendMode
from ..utils.misc import ensure_tuple_rep, ensure_tuple_size, first

__all__ = ["compute_importance_map", "dense_patch_slices", "get_valid_patch_size"]


def get_valid_patch_size(image_size: Sequence[int], patch_size: Sequence[int] | int) -> tuple:
    """Clamp ``patch_size`` to ``image_size``; a patch size of 0 or None means the whole dim."""
    patch_size_ = ensure_tuple_size(patch_size, len(image_size))
    return tuple(min(ms, ps if ps is not None and ps > 0 else ms) for ms, ps in zip(image_size, patch_size_))


def dense_patch_slices(image_size: Sequence[int], patch_size: Sequence[int],
                       scan_interval: Sequence[int], return_slice: bool = True) -> list:
    """All windows of a sliding scan over ``image_size``, in row-major order, the last
    window of each dim pulled back to end at the image border."""
    num_spatial_dims = len(image_size)
    patch_size = get_valid_patch_size(image_size, patch_size)
    scan_interval = ensure_tuple_size(scan_interval, num_spatial_dims)

    scan_num = []
    for i in range(num_spatial_dims):
        if scan_interval[i] == 0:
            scan_num.append(1)
        else:
            num = int(math.ceil(float(image_size[i]) / scan_interval[i]))
            scan_dim = first(d for d in range(num) if d * scan_interval[i] + patch_size[i] >= image_size[i])
            scan_num.append(scan_dim + 1 if scan_dim is not None else 1)

    starts = []
    for dim in range(num_spatial_dims):
        dim_starts = []
        for idx in range(scan_num[dim]):
            start_idx = idx * scan_interval[dim]
            start_idx -= max(start_idx + patch_size[dim] - image_size[dim], 0)
            dim_starts.append(start_idx)
        starts.append(dim_starts)
    out = np.asarray([x.flatten() for x in np.meshgrid(*starts, indexing="ij")]).T
    if return_slice:
        return [tuple(slice(int(s), int(s) + patch_size[d]) for d, s in enumerate(x)) for x in out]
    return [tuple((int(s), int(s) + patch_size[d]) for d, s in enumerate(x)) for x in out]


def compute_importance_map(patch_size: Sequence[int], mode: str = BlendMode.CONSTANT,
                           sigma_scale: Sequence[float] | float = 0.125, device=None,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Blend weights for window stitching. ``gaussian``: a separable centred Gaussian with
    sigma = sigma_scale * size per dim, not renormalised, min-clamped at its smallest
    value or 1e-3, whichever is larger, so no voxel gets zero weight."""
    if str(mode) == str(BlendMode.CONSTANT):
        return torch.ones(tuple(patch_size), dtype=dtype, device=device)
    if str(mode) != str(BlendMode.GAUSSIAN):
        raise ValueError(f"Unsupported mode: {mode}, available options are ['constant', 'gaussian'].")
    sigma_scale_ = ensure_tuple_rep(sigma_scale, len(patch_size))
    out = np.ones(tuple(patch_size), dtype=np.float32)
    for d, (size, s) in enumerate(zip(patch_size, sigma_scale_)):
        sigma = size * s
        x = np.arange(-(size - 1) / 2.0, (size - 1) / 2.0 + 1, dtype=np.float32)
        g = np.exp(x ** 2 / np.float32(-2 * sigma ** 2))
        shape = [1] * len(patch_size)
        shape[d] = size
        out = out * g.reshape(shape)
    out = np.clip(out, a_min=max(float(out.min()), 1e-3), a_max=None)
    return torch.from_numpy(out).to(device=device, dtype=dtype)
