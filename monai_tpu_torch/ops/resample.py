"""Sampling a channel-first tensor at continuous voxel coordinates (counterpart of
monai_tpu/ops/resample.py::grid_pull at orders 0 and 1).

Any number of spatial axes: the bilateral grid slices a 3-D image's grid in four, the
PHL grid up to five, and ``F.grid_sample`` stops at three. Nearest and multilinear
interpolation with the bounds zeros, border and reflection, computed as the JAX package
computes them (a gather per corner, the corners in row-major order). Other orders and
bounds wait for the ROADMAP item 'Native ops'.
"""
from __future__ import annotations

import itertools

import torch

__all__ = ["grid_pull"]

_BOUNDS = ("zeros", "border", "reflection")


def _reflect(c: torch.Tensor, n: int) -> torch.Tensor:
    """Continuous coordinates reflected about -0.5 and n - 0.5 into [0, n - 1]."""
    if n == 1:
        return torch.zeros_like(c)
    period = 2.0 * n
    c = torch.remainder(c + 0.5, period)
    c = torch.where(c >= n, period - c, c)
    return (c - 0.5).clamp(0.0, float(n - 1))


def grid_pull(input: torch.Tensor, grid: torch.Tensor, interpolation: int = 1, bound: str = "zeros") -> torch.Tensor:
    """Sample ``input`` (C, *in_spatial) at the voxel coordinates ``grid`` (*out_spatial, D)
    at order ``interpolation`` (0 nearest, 1 multilinear); returns (C, *out_spatial) in the
    input's type (order 1: a floating one; sums in float32, float64 for a float64 input)."""
    if interpolation not in (0, 1) or bound not in _BOUNDS:
        raise NotImplementedError(f"grid_pull takes orders 0 and 1 and bounds {_BOUNDS}; got {interpolation!r}, "
                                  f"{bound!r} (other orders and bounds: the ROADMAP item 'Native ops')")
    nd = grid.shape[-1]
    in_spatial = input.shape[1:]
    if len(in_spatial) != nd:
        raise ValueError(f"grid last dim {nd} != input spatial rank {len(in_spatial)}")
    c_in = input.shape[0]
    out_spatial = grid.shape[:-1]
    compute = torch.float64 if input.dtype == torch.float64 else torch.float32
    flat_in = input.to(compute).reshape(c_in, -1)
    strides = [1] * nd
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * int(in_spatial[d + 1])
    coords = []
    for d in range(nd):
        c = grid[..., d].to(compute)
        if bound == "reflection":
            c = _reflect(c, int(in_spatial[d]))
        elif bound == "border":
            c = c.clamp(0.0, float(in_spatial[d] - 1))
        coords.append(c)

    def gather(flat_idx: torch.Tensor) -> torch.Tensor:
        return flat_in[:, flat_idx.reshape(-1)].reshape((c_in, *out_spatial))

    if interpolation == 0:
        flat_idx, mask = 0, None
        for d in range(nd):
            r = torch.floor(coords[d] + 0.5)
            if bound == "zeros":
                m = (r >= 0) & (r <= in_spatial[d] - 1)
                mask = m if mask is None else mask & m
            flat_idx = flat_idx + r.clamp(0, in_spatial[d] - 1).long() * strides[d]
        vals = gather(flat_idx)
        return (vals if mask is None else vals * mask.to(compute)).to(input.dtype)
    base = [torch.floor(c) for c in coords]
    frac = [c - f for c, f in zip(coords, base)]
    base = [f.long() for f in base]
    out = None
    for corner in itertools.product((0, 1), repeat=nd):
        w, flat_idx, mask = None, 0, None
        for d, k in enumerate(corner):
            idx = base[d] + k
            w_d = frac[d] if k == 1 else 1.0 - frac[d]
            if bound == "zeros":
                m = (idx >= 0) & (idx <= in_spatial[d] - 1)
                mask = m if mask is None else mask & m
            w = w_d if w is None else w * w_d
            flat_idx = flat_idx + idx.clamp(0, in_spatial[d] - 1) * strides[d]
        if mask is not None:
            w = w * mask.to(compute)
        term = gather(flat_idx) * w[None]
        out = term if out is None else out + term
    return out.to(input.dtype) if input.dtype.is_floating_point else out
