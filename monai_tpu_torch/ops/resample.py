"""N-D grid resampling, pull and push (counterpart of monai_tpu/ops/resample.py).

``grid`` holds voxel coordinates of the input (not torch's normalised [-1, 1]); the affine
helpers build output-voxel to input-voxel maps. Any number of spatial axes: the
bilateral grid slices a 3-D image's grid in four, the PHL grid up to five, and
``F.grid_sample`` stops at three.

- ``grid_pull`` samples at spline orders 0-7 (order 3 is torch's Keys cubic unless
  ``interpolation="bspline"``) under the eight bounds of the reference (zero, replicate,
  dct1, dct2, dst1, dst2, dft, sliding), or a bound a spatial axis. Orders 0, 1 and the
  Keys cubic at zeros, border and reflection gather per corner as the JAX package's torch
  semantics do; every other case runs the B-spline tap engine.
- ``grid_push`` is its adjoint, a scatter-add with the same taps, and ``grid_count`` the
  push of ones; ``grid_grad`` the gradient of the pull with respect to the coordinates,
  by autograd, per channel.
- ``affine_grid`` and ``affine_resample`` give the general affine resample, tier 3 of
  ``transforms/lazy_utils.py``.

Sums run in float32, float64 for a float64 input, on the input's device. On a CUDA
device the scatter-add of ``grid_push`` adds in no fixed order.
"""
from __future__ import annotations

import itertools
from collections.abc import Sequence
from math import comb, factorial
from typing import Any

import numpy as np
import torch

__all__ = ["grid_pull", "grid_push", "grid_count", "grid_grad", "affine_grid", "affine_resample", "resolve_mode",
           "resolve_bound"]

_ORDER = {"nearest": 0, "nearest-exact": 0, 0: 0, "bilinear": 1, "linear": 1, "trilinear": 1, 1: 1,
          # torch's 'area' has no spline counterpart; the JAX package samples it linearly
          "area": 1,
          "quadratic": 2, 2: 2, "bicubic": 3, "cubic": 3, 3: 3,
          "fourth": 4, 4: 4, "fifth": 5, 5: 5, "sixth": 6, 6: 6, "seventh": 7, 7: 7}

# the reference's eight bounds and torch's names for them
_BOUND_ALIASES = {
    "zeros": "zero", "zero": "zero", "constant": "zero",
    "border": "replicate", "replicate": "replicate", "nearest": "replicate",
    "reflection": "dct2", "reflect": "dct2", "dct2": "dct2",
    "mirror": "dct1", "dct1": "dct1",
    "antireflect": "dst2", "dst2": "dst2",
    "antimirror": "dst1", "dst1": "dst1",
    "wrap": "dft", "circular": "dft", "dft": "dft",
    "sliding": "sliding",
}
# the bounds of the gather-per-corner path, by their torch names
_TORCH_BOUNDS = {"zero": "zeros", "replicate": "border", "dct2": "reflection"}


def resolve_mode(mode: Any) -> int:
    """An interpolation mode name or spline order as the order, 0 to 7."""
    if mode in _ORDER:
        return _ORDER[mode]
    raise ValueError(f"Unsupported interpolation mode: {mode!r}")


def resolve_bound(bound: Any):
    """A bound's canonical name; a list or tuple gives one a spatial axis, in the order of
    the grid's last axis. 'sliding' cannot be given a spatial axis."""
    if isinstance(bound, (list, tuple)):
        resolved = tuple(resolve_bound(b) for b in bound)
        if "sliding" in resolved:
            raise ValueError("'sliding' cannot be combined with per-dimension bounds.")
        return resolved
    key = str(bound).lower()
    if key in _BOUND_ALIASES:
        return _BOUND_ALIASES[key]
    raise ValueError(f"Unsupported bound mode: {bound!r}")


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _strides(spatial: Sequence[int]) -> list[int]:
    strides = [1] * len(spatial)
    for d in range(len(spatial) - 2, -1, -1):
        strides[d] = strides[d + 1] * int(spatial[d + 1])
    return strides


def _bound_tap(idx: torch.Tensor, n: int, bound: str):
    """Integer tap indices mapped into [0, n - 1] by ``bound``: (index, sign, mask), where
    ``sign`` multiplies the sample (the antisymmetric bounds) and ``mask`` zeroes it; either
    may be None."""
    if bound == "zero":
        return idx.clamp(0, n - 1), None, (idx >= 0) & (idx <= n - 1)
    if bound == "replicate":
        return idx.clamp(0, n - 1), None, None
    if n == 1:
        return torch.zeros_like(idx), None, None
    if bound == "dct2":  # reflect about -0.5 and n - 0.5
        x = torch.remainder(idx, 2 * n)
        return torch.where(x >= n, 2 * n - 1 - x, x), None, None
    if bound == "dct1":  # mirror about 0 and n - 1
        period = 2 * (n - 1)
        x = torch.remainder(idx, period)
        return torch.where(x >= n, period - x, x), None, None
    if bound == "dft":
        return torch.remainder(idx, n), None, None
    if bound == "dst2":  # antisymmetric about -0.5 and n - 0.5
        x = torch.remainder(idx, 2 * n)
        refl = x >= n
        return torch.where(refl, 2 * n - 1 - x, x), torch.where(refl, -1.0, 1.0), None
    if bound == "dst1":  # antisymmetric, with nodes at -1 and n
        u = torch.remainder(idx + 1, 2 * (n + 1))
        refl = u > n + 1
        xi = torch.where(refl, 2 * n + 1 - u, u - 1).clamp(0, n - 1)
        return xi, torch.where(refl, -1.0, 1.0), (u != 0) & (u != n + 1)
    raise NotImplementedError(f"bound {bound!r} has no tap rule ('sliding' is split a channel before here)")


def _bspline_kernel(order: int, u: torch.Tensor) -> torch.Tensor:
    """The centred B-spline of degree ``order`` at offsets ``u``, as divided differences of
    truncated powers."""
    x = u + (order + 1) / 2.0
    out = None
    for k in range(order + 2):
        term = ((-1.0) ** k) * comb(order + 1, k) * torch.clamp_min(x - k, 0.0) ** order
        out = term if out is None else out + term
    return out / factorial(order)


def _spline_taps(grid: torch.Tensor, spatial: Sequence[int], order: int, bound, compute: torch.dtype) -> list:
    """Each spatial axis's taps, [(index, weight, sign, mask), ...] (weight None at order
    0), shared by the pull and the push so that the push is the pull's adjoint."""
    nd = grid.shape[-1]
    bounds = bound if isinstance(bound, (list, tuple)) else (bound,) * nd
    taps = []
    for d in range(nd):
        c = grid[..., d].to(compute)
        if order == 0:  # half to even, as torch's nearest
            dim_taps = [(torch.round(c).long(), None)]
        elif order == 1:
            f = torch.floor(c)
            t = c - f
            dim_taps = [(f.long(), 1.0 - t), (f.long() + 1, t)]
        else:
            base = (torch.floor(c).long() - (order - 1) // 2 if order % 2
                    else torch.floor(c + 0.5).long() - order // 2)
            # the offsets are exact in float32; the truncated powers cancel (x^7 up to 4^7), so
            # they are summed in float64 and the weights rounded once
            dim_taps = [(base + k, _bspline_kernel(order, (c - (base + k).to(compute)).double()).to(compute))
                        for k in range(order + 1)]
        resolved = []
        for i, w in dim_taps:
            xi, sign, mask = _bound_tap(i, int(spatial[d]), bounds[d])
            resolved.append((xi, w, sign, mask))
        taps.append(resolved)
    return taps


def _sliding_bounds(nd: int) -> list[tuple]:
    """The 'sliding' bound of a flow field split a channel: channel ``c`` is antisymmetric
    (dst2) along spatial axis ``c`` and symmetric (dct2) along the others."""
    return [tuple("dst2" if d == c else "dct2" for d in range(nd)) for c in range(nd)]


def _check_sliding_channels(channels: int, nd: int, op: str) -> None:
    if channels != nd:
        raise ValueError(f"'sliding' only applies to flow fields with as many channels as spatial dims; {op} got "
                         f"C={channels}, D={nd}.")


def _spline_corners(taps: list, strides: Sequence[int], compute: torch.dtype):
    """(flat index, weight or None) of each corner of the taps, in row-major order."""
    for corner in itertools.product(*[range(len(t)) for t in taps]):
        w, flat = None, 0
        for d, k in enumerate(corner):
            xi, w_k, sign, mask = taps[d][k]
            wd = w_k
            if sign is not None:
                wd = sign.to(compute) if wd is None else wd * sign
            if mask is not None:
                wd = mask.to(compute) if wd is None else wd * mask.to(compute)
            if wd is not None:
                w = wd if w is None else w * wd
            flat = flat + xi * strides[d]
        yield flat, w


def _grid_pull_spline(input: torch.Tensor, grid: torch.Tensor, order: int, bound) -> torch.Tensor:
    c_in, in_spatial, out_spatial = input.shape[0], input.shape[1:], grid.shape[:-1]
    compute = _compute_dtype(input)
    flat_in = input.to(compute).reshape(c_in, -1)
    taps = _spline_taps(grid, in_spatial, order, bound, compute)
    out = None
    for flat, w in _spline_corners(taps, _strides(in_spatial), compute):
        vals = flat_in[:, flat.reshape(-1)].reshape((c_in, *out_spatial))
        term = vals if w is None else vals * w[None]
        out = term if out is None else out + term
    return out.to(input.dtype) if input.dtype.is_floating_point else out


def _reflect(c: torch.Tensor, n: int, align_corners: bool = False) -> torch.Tensor:
    """Continuous coordinates reflected into [0, n - 1]: about -0.5 and n - 0.5, or about 0
    and n - 1 with ``align_corners``."""
    if n == 1:
        return torch.zeros_like(c)
    if align_corners:
        period = 2.0 * (n - 1)
        c = torch.remainder(c, period)
        c = torch.where(c >= n - 1, period - c, c)
        return c.clamp(0.0, float(n - 1))
    period = 2.0 * n
    c = torch.remainder(c + 0.5, period)
    c = torch.where(c >= n, period - c, c)
    return (c - 0.5).clamp(0.0, float(n - 1))


def _prep_coords(c: torch.Tensor, n: int, bound: str, align_corners: bool) -> torch.Tensor:
    if bound == "reflection":
        return _reflect(c, n, align_corners)
    if bound == "border":
        return c.clamp(0.0, float(n - 1))
    return c


def _reflect_tap(idx: torch.Tensor, n: int, align_corners: bool) -> torch.Tensor:
    """Integer tap indices reflected into range (the Keys cubic's bound a tap)."""
    if n == 1:
        return torch.zeros_like(idx)
    if align_corners:
        period = 2 * (n - 1)
        x = torch.remainder(idx, period)
        return torch.where(x >= n - 1, period - x, x)
    x = torch.remainder(idx, 2 * n)
    return torch.where(x >= n, 2 * n - 1 - x, x)


def _cubic_weights(t: torch.Tensor) -> list[torch.Tensor]:
    """Keys cubic convolution weights (a = -0.75, torch's bicubic) of the taps at offsets
    -1, 0, 1, 2 from the floor, for the fraction ``t`` in [0, 1)."""
    a = -0.75

    def near(d):
        return ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0

    def far(d):
        return ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a

    return [far(1.0 + t), near(t), near(1.0 - t), far(2.0 - t)]


def grid_pull(input: torch.Tensor, grid: torch.Tensor, interpolation: Any = 1, bound: Any = "zeros",
              align_corners: bool = False) -> torch.Tensor:
    """Sample ``input`` (C, *in_spatial) at the voxel coordinates ``grid`` (*out_spatial, D)
    at spline order ``interpolation`` (0-7, a mode name, or "bspline" for the cubic
    B-spline) under ``bound``; ``align_corners`` moves the reflection bound's mirrors only.
    Returns (C, *out_spatial) in the input's type (a floating one; sums in float32,
    float64 for a float64 input)."""
    canon = resolve_bound(bound)
    nd = grid.shape[-1]
    if canon == "sliding":
        _check_sliding_channels(input.shape[0], nd, "grid_pull")
        return torch.cat([grid_pull(input[c:c + 1], grid, interpolation, bc, align_corners)
                          for c, bc in enumerate(_sliding_bounds(nd))])
    if str(interpolation).lower() in ("bspline", "bspline3"):
        return _grid_pull_spline(input, grid, 3, canon)
    order = resolve_mode(interpolation)
    in_spatial = input.shape[1:]
    if len(in_spatial) != nd:
        raise ValueError(f"grid last dim {nd} != input spatial rank {len(in_spatial)}")
    if order in (2, 4, 5, 6, 7) or isinstance(canon, tuple) or canon not in _TORCH_BOUNDS:
        return _grid_pull_spline(input, grid, order, canon)
    bound = _TORCH_BOUNDS[canon]
    c_in, out_spatial = input.shape[0], grid.shape[:-1]
    compute = _compute_dtype(input)
    flat_in = input.to(compute).reshape(c_in, -1)
    strides = _strides(in_spatial)
    sizes = [int(s) for s in in_spatial]

    def gather(flat_idx: torch.Tensor) -> torch.Tensor:
        return flat_in[:, flat_idx.reshape(-1)].reshape((c_in, *out_spatial))

    if order == 0:
        flat_idx, mask = 0, None
        for d in range(nd):
            r = torch.floor(_prep_coords(grid[..., d].to(compute), sizes[d], bound, align_corners) + 0.5)
            if bound == "zeros":
                m = (r >= 0) & (r <= sizes[d] - 1)
                mask = m if mask is None else mask & m
            flat_idx = flat_idx + r.clamp(0, sizes[d] - 1).long() * strides[d]
        vals = gather(flat_idx)
        return (vals if mask is None else vals * mask.to(compute)).to(input.dtype)

    if order == 1:
        coords = [_prep_coords(grid[..., d].to(compute), sizes[d], bound, align_corners) for d in range(nd)]
        base = [torch.floor(c) for c in coords]
        frac = [c - f for c, f in zip(coords, base)]
        base = [f.long() for f in base]
        offsets, weights = (0, 1), lambda d, k: frac[d] if k == 1 else 1.0 - frac[d]
    else:  # the Keys cubic: weights from the unclamped coordinate, the bound a tap
        coords = [grid[..., d].to(compute) for d in range(nd)]
        base = [torch.floor(c) for c in coords]
        cubic = [_cubic_weights(c - f) for c, f in zip(coords, base)]
        base = [f.long() for f in base]
        offsets, weights = (-1, 0, 1, 2), lambda d, k: cubic[d][k + 1]
    out = None
    for corner in itertools.product(offsets, repeat=nd):
        w, flat_idx, mask = None, 0, None
        for d, k in enumerate(corner):
            idx = base[d] + k
            if bound == "zeros":
                m = (idx >= 0) & (idx <= sizes[d] - 1)
                mask = m if mask is None else mask & m
            elif bound == "reflection" and order == 3:
                idx = _reflect_tap(idx, sizes[d], align_corners)
            w = weights(d, k) if w is None else w * weights(d, k)
            flat_idx = flat_idx + idx.clamp(0, sizes[d] - 1) * strides[d]
        if mask is not None:
            w = w * mask.to(compute)
        term = gather(flat_idx) * w[None]
        out = term if out is None else out + term
    return out.to(input.dtype) if input.dtype.is_floating_point else out


def _grid_push_spline(input: torch.Tensor, grid: torch.Tensor, shape: tuple, order: int, bound) -> torch.Tensor:
    """The adjoint of ``_grid_pull_spline``: a splat with the same taps."""
    c_in = input.shape[0]
    compute = _compute_dtype(input)
    inp = input.reshape(c_in, -1).to(compute)
    taps = _spline_taps(grid.reshape(-1, grid.shape[-1]), shape, order, bound, compute)
    out = torch.zeros((c_in, int(np.prod(shape))), dtype=compute, device=input.device)
    for flat, w in _spline_corners(taps, _strides(shape), compute):
        out.index_add_(1, flat, inp if w is None else inp * w[None])
    return out.reshape((c_in, *shape))


def grid_push(input: torch.Tensor, grid: torch.Tensor, shape: Sequence[int], interpolation: Any = 1,
              bound: Any = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Splat ``input`` (C, *grid_spatial) at the voxel coordinates ``grid``
    (*grid_spatial, D) into a (C, *shape) output: the adjoint of ``grid_pull`` with the
    same orders and bounds. Orders 0, 1 and the Keys cubic at zeros, border and reflection
    splat at the coordinates after their bound (the JAX package's rule; the cubic's pull
    bounds a tap instead, so there the two are not adjoint but at zeros); the B-spline
    engine splats with the pull's own taps. float32 sums (float64 for float64), added in no
    fixed order on a CUDA device."""
    canon = resolve_bound(bound)
    nd = grid.shape[-1]
    shape = tuple(int(s) for s in shape)
    if canon == "sliding":
        _check_sliding_channels(input.shape[0], nd, "grid_push")
        return torch.cat([grid_push(input[c:c + 1], grid, shape, interpolation, bc, align_corners)
                          for c, bc in enumerate(_sliding_bounds(nd))])
    if str(interpolation).lower() in ("bspline", "bspline3"):
        return _grid_push_spline(input, grid, shape, 3, canon)
    order = resolve_mode(interpolation)
    if order in (2, 4, 5, 6, 7) or isinstance(canon, tuple) or canon not in _TORCH_BOUNDS:
        return _grid_push_spline(input, grid, shape, order, canon)
    bound = _TORCH_BOUNDS[canon]
    c_in = input.shape[0]
    compute = _compute_dtype(input)
    inp = input.reshape(c_in, -1).to(compute)
    strides = _strides(shape)
    coords = [_prep_coords(grid[..., d].reshape(-1).to(compute), shape[d], bound, align_corners) for d in range(nd)]
    if order == 0:
        base, frac, offsets = [torch.floor(c + 0.5).long() for c in coords], None, (0,)
    else:
        floors = [torch.floor(c) for c in coords]
        base, frac = [f.long() for f in floors], [c - f for c, f in zip(coords, floors)]
        offsets = (0, 1) if order == 1 else (-1, 0, 1, 2)
    cubic = [_cubic_weights(t) for t in frac] if order == 3 else None
    out = torch.zeros((c_in, int(np.prod(shape))), dtype=compute, device=input.device)
    for corner in itertools.product(offsets, repeat=nd):
        w, flat_idx, mask = None, 0, None
        for d, k in enumerate(corner):
            idx = base[d] + k
            if order == 1:
                w_d = frac[d] if k == 1 else 1.0 - frac[d]
            elif order == 3:
                w_d = cubic[d][k + 1]
            else:
                w_d = None
            m = (idx >= 0) & (idx <= shape[d] - 1)
            mask = m if mask is None else mask & m
            if w_d is not None:
                w = w_d if w is None else w * w_d
            flat_idx = flat_idx + idx.clamp(0, shape[d] - 1) * strides[d]
        w = (torch.ones_like(coords[0]) if w is None else w) * mask.to(compute)
        out.index_add_(1, flat_idx, inp * w[None])
    return out.reshape((c_in, *shape))


def grid_count(grid: torch.Tensor, shape: Sequence[int], interpolation: Any = 1, bound: Any = "zeros") -> torch.Tensor:
    """``grid_push`` of ones: the normalisation map of a push, (*shape). Under 'sliding' a
    count has no flow component to be antisymmetric about, so it takes dct2 on every axis."""
    if resolve_bound(bound) == "sliding":
        bound = "dct2"
    dtype = grid.dtype if grid.dtype.is_floating_point else torch.float32
    flat_grid = grid.reshape(-1, grid.shape[-1])
    ones = torch.ones((1, flat_grid.shape[0]), dtype=dtype, device=grid.device)
    return grid_push(ones, flat_grid, shape, interpolation, bound)[0]


def grid_grad(input: torch.Tensor, grid: torch.Tensor, interpolation: Any = 1, bound: Any = "zeros",
              align_corners: bool = False) -> torch.Tensor:
    """The gradient of ``grid_pull`` with respect to the coordinates, (C, *out_spatial, D):
    each output point depends on its own coordinate only, so one backward a channel of the
    pull's sum gives it. At an integer coordinate order 1 takes the weights of the floor and
    the voxel after it, so its gradient is the difference to the right, as the JAX
    package's ``jax.grad``."""
    nd = grid.shape[-1]
    bounds = [bound] * input.shape[0]
    if resolve_bound(bound) == "sliding":
        _check_sliding_channels(input.shape[0], nd, "grid_grad")
        bounds = _sliding_bounds(nd)
    grads = []
    with torch.enable_grad():
        for c, bc in enumerate(bounds):
            g = grid.detach().clone().requires_grad_(True)
            out = grid_pull(input[c:c + 1].detach(), g, interpolation, bc, align_corners)
            grads.append(torch.autograd.grad(out.sum(), g)[0])
    return torch.stack(grads)


def affine_grid(matrix: Any, out_shape: Sequence[int], device=None) -> torch.Tensor:
    """The voxel coordinates (*out_shape, D), in float64, of an output-to-input
    (D + 1, D + 1) affine: grid[idx] = (matrix @ [idx, 1])[:D]."""
    m = torch.as_tensor(matrix, dtype=torch.float64, device=device)
    nd = len(out_shape)
    axes = [torch.arange(int(s), dtype=torch.float64, device=m.device) for s in out_shape]
    mesh = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return torch.tensordot(mesh, m[:nd, :nd].T, dims=1) + m[:nd, nd]


def affine_resample(img: torch.Tensor, matrix: Any, out_shape: Sequence[int], mode: Any = 1,
                    padding_mode: Any = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Resample channel-first ``img`` by the output-voxel to input-voxel affine ``matrix``
    into ``out_shape``, on the image's device (the grid in float64, rounded to the sums'
    type by the pull)."""
    grid = affine_grid(matrix, tuple(out_shape), device=img.device)
    return grid_pull(img, grid, interpolation=mode, bound=padding_mode, align_corners=align_corners)
