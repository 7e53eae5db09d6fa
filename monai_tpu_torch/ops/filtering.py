"""Bilateral and guided high-dimensional filtering (counterpart of
monai_tpu/ops/filtering.py).

- ``bilateral_filter``: the brute-force stencil. A 2-D or 3-D CUDA tensor runs the
  hand-written kernel (``ops/bilateral.py``) at any radius; every other tensor (the CPU,
  1-D inputs) runs its plain PyTorch version. ``fast_approx`` takes the bilateral grid.
- ``bilateral_grid_filter``: splat, blur, slice on a regular grid with an intensity axis
  (Chen et al.), one (batch, channel) plane at a time.
- ``phl_filter``: filtering with arbitrary feature vectors; exact for N <= 4096 voxels, a
  regular feature grid for F <= 5, the permutohedral lattice beyond.
"""
from __future__ import annotations

import numpy as np
import torch

from .bilateral import bilateral_stencil, bilateral_stencil_plain
from .gaussian import gaussian_filter
from .permutohedral import permutohedral_filter
from .resample import grid_pull

__all__ = ["bilateral_filter", "bilateral_grid_filter", "phl_filter"]


def bilateral_filter(img: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
                     fast_approx: bool = False, truncate: float = 2.0) -> torch.Tensor:
    """Bilateral filter of (B, C, *spatial) ``img`` on its own device (reference:
    monai/networks/layers/filtering.py:23 BilateralFilter)."""
    if fast_approx:
        return bilateral_grid_filter(img, spatial_sigma, color_sigma)
    if img.device.type == "cuda" and img.ndim in (4, 5):
        return bilateral_stencil(img, spatial_sigma, color_sigma, truncate)
    return bilateral_stencil_plain(img, spatial_sigma, color_sigma, truncate)


def bilateral_grid_filter(img: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
                          grid_pad: int = 2) -> torch.Tensor:
    """Splat-blur-slice bilateral grid: each (batch, channel) plane gets a grid of its
    spatial axes downsampled by max(spatial_sigma, 1) and an intensity axis of cells
    max(color_sigma, 1e-3) of its range wide; nearest splat of the values and of ones,
    a unit-sigma Gaussian blur over every grid axis, multilinear slice, divide."""
    spatial = img.shape[2:]
    s_rate = max(spatial_sigma, 1.0)
    c_rate = max(color_sigma, 1e-3)
    dims = tuple(int(np.ceil(s / s_rate)) + 2 * grid_pad for s in spatial) + (int(np.ceil(1.0 / c_rate)) + 2 * grid_pad,)
    strides = [int(np.prod(dims[d + 1:])) for d in range(len(dims))]
    mesh = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=img.device) / s_rate + grid_pad
                            for s in spatial], indexing="ij")
    mesh_idx = sum(torch.round(m).long() * s for m, s in zip(mesh, strides))

    def one(x: torch.Tensor) -> torch.Tensor:
        mn = x.min()
        rng = torch.clamp(x.max() - mn, min=1e-8)
        zc = (x - mn) / rng / c_rate + grid_pad
        flat_idx = (mesh_idx + torch.round(zc).long() * strides[-1]).reshape(-1)
        grid = x.new_zeros((2, int(np.prod(dims))))
        grid[0].index_add_(0, flat_idx, x.reshape(-1))
        grid[1].index_add_(0, flat_idx, torch.ones_like(x).reshape(-1))
        blurred = gaussian_filter(grid.reshape((2, *dims)), sigma=1.0)
        vals = grid_pull(blurred, torch.stack([*mesh, zc], dim=-1), interpolation=1, bound="border")
        return vals[0] / torch.clamp(vals[1], min=1e-8)

    flat = img.reshape(-1, *spatial)
    return torch.stack([one(x) for x in flat]).reshape(img.shape)


# Feature-grid bins per feature dimension, cells 1 sigma wide: a feature axis represents
# (bins - 2·pad)·sigma of range before extreme values clamp to the boundary cell.
_PHL_GRID_BINS = {1: 256, 2: 96, 3: 40, 4: 24, 5: 16}
_PHL_GRID_PAD = 2


def phl_filter(data: torch.Tensor, features: torch.Tensor, sigmas=None) -> torch.Tensor:
    """Guided filtering of ``data`` (B, C, *spatial) with arbitrary feature vectors
    ``features`` (B, F, *spatial) (reference: PHLFilter, monai/networks/layers/filtering.py:66):
    ``features[:, i]`` is divided by ``sigmas[i]`` and the weights are the unit Gaussian
    W_ij = exp(-|f'_i - f'_j|^2 / 2) of the scaled features.

    N <= 4096 voxels: exact, the dense weight matrix. Larger, F <= 5: splat-blur-slice on
    a regular grid over the scaled feature space, 1 sigma cells (256/96/40/24/16 bins for
    F = 1..5; a range beyond (bins - 4) sigma clamps to the boundary cell). Larger, F > 5:
    the permutohedral lattice.
    """
    b, c = data.shape[:2]
    f = features.shape[1]
    n = int(np.prod(data.shape[2:]))
    features = features.float()
    if sigmas is not None:
        features = features / torch.as_tensor(sigmas, dtype=torch.float32, device=features.device).reshape(
            (1, f) + (1,) * (features.ndim - 2))
    if n <= 4096:
        feat = features.reshape(b, f, n)
        d2 = ((feat[:, :, :, None] - feat[:, :, None, :]) ** 2).sum(dim=1)  # (B, N, N)
        w = torch.exp(-0.5 * d2)
        num = torch.einsum("bnm,bcm->bcn", w, data.reshape(b, c, n).to(w.dtype))
        den = w.sum(dim=2)[:, None]
        return (num / torch.clamp(den, min=1e-8)).reshape(data.shape)
    if f not in _PHL_GRID_BINS:
        return permutohedral_filter(data, features)
    return _phl_grid_filter(data, features, n)


def _gauss_band_matrix(length: int, sigma: float = 1.0, truncate: float = 4.0) -> np.ndarray:
    """(L, L) float32 'same', zero-padded 1-D Gaussian correlation as a banded matrix."""
    radius = max(int(truncate * sigma + 0.5), 1)
    taps = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    taps /= taps.sum()
    w = np.zeros((length, length), np.float32)
    for off, t in zip(range(-radius, radius + 1), taps):
        w += np.diag(np.full(length - abs(off), t, np.float32), k=off)
    return w


def _phl_grid_filter(data: torch.Tensor, scaled_features: torch.Tensor, n: int) -> torch.Tensor:
    """Splat-blur-slice over a regular grid in the (sigma-scaled) feature space, one batch
    item at a time."""
    b, c = data.shape[:2]
    f = scaled_features.shape[1]
    bins, pad = _PHL_GRID_BINS[f], _PHL_GRID_PAD
    dims = (bins,) * f
    strides = torch.tensor([bins ** (f - 1 - d) for d in range(f)], device=data.device)
    blur_w = torch.from_numpy(_gauss_band_matrix(bins)).to(data.device)

    def one(x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:  # x (C, N), feat (F, N)
        g = torch.clamp(feat - feat.min(dim=1, keepdim=True).values, 0.0, bins - 1 - 2 * pad) + pad
        flat_idx = (torch.round(g).long() * strides[:, None]).sum(dim=0)
        vals = torch.cat([x, x.new_ones((1, n))], dim=0)  # (C+1, N)
        grid = x.new_zeros((c + 1, bins ** f)).index_add_(1, flat_idx, vals)
        blurred = grid.reshape((c + 1, *dims))
        for ax in range(1, f + 1):
            blurred = (blurred.movedim(ax, -1) @ blur_w).movedim(-1, ax)
        out = grid_pull(blurred, g.T, interpolation=1, bound="border")
        return out[:c] / torch.clamp(out[c:], min=1e-8)

    x = data.reshape(b, c, n).float()
    feat = scaled_features.reshape(b, f, n)
    return torch.stack([one(x[i], feat[i]) for i in range(b)]).reshape(data.shape).to(data.dtype)
