"""Brute-force bilateral filter of (B, C, *spatial) tensors on a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_filtering.py::bilateral_filter_pallas (TPU kernels
``_run_2d`` and ``_run_3d``), which computes what the XLA stencil of
monai_tpu/ops/filtering.py::bilateral_filter computes: for every voxel, the weighted mean
of its edge-padded (2r+1)^sd neighbourhood, each neighbour weighted by a spatial Gaussian
of its offset times a range Gaussian of its difference to the centre, with
r = max(int(truncate * spatial_sigma + 0.5), 1). The kernel is ``csrc/bilateral_filter.cu``
(one source, a 2-D and a 3-D kernel); its header says what bounds it on the card and what
the design does about that. It takes any radius. ``bilateral_stencil_plain`` is the
stencil in PyTorch: the tests hold it to the JAX package, and the card holds the kernel
to it. ``bilateral_stencil`` takes CUDA tensors only and launches the kernel or raises;
``ops/filtering.py::bilateral_filter`` sends every other tensor to the plain version.
Forward only.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from collections.abc import Sequence

import numpy as np
import torch

from ._build import library

__all__ = ["bilateral_stencil", "bilateral_stencil_plain", "edge_pad", "filter_radius", "spatial_weights"]


def filter_radius(spatial_sigma: float, truncate: float = 2.0) -> int:
    """The stencil's radius, as the JAX package sets it."""
    return max(int(truncate * float(spatial_sigma) + 0.5), 1)


@functools.lru_cache(maxsize=64)
def spatial_weights(spatial_sigma: float, radius: int, sd: int) -> np.ndarray:
    """(2r+1)^sd float32 spatial weights exp(-|o|^2 * 0.5 / sigma^2), offsets in row-major
    order; each computed in float64 and rounded once, as the JAX stencil rounds its
    Python-float weight against a float32 array. Read-only."""
    w = np.array([math.exp(-0.5 * sum(o * o for o in off) / (spatial_sigma ** 2))
                  for off in itertools.product(range(-radius, radius + 1), repeat=sd)], dtype=np.float32)
    w.flags.writeable = False
    return w


def edge_pad(x: torch.Tensor, radii: Sequence[int]) -> torch.Tensor:
    """Pad the spatial axes of (B, C, *spatial) ``x`` by ``radii[d]`` on both sides with
    the edge value (``jnp.pad(mode="edge")``), for any number of axes and any size."""
    for d, r in enumerate(radii):
        n = x.shape[2 + d]
        idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
        x = x.index_select(2 + d, idx)
    return x


def bilateral_stencil_plain(img: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
                            truncate: float = 2.0) -> torch.Tensor:
    """The stencil in PyTorch, any number of spatial axes: the JAX package's loop over
    the offsets, in float32 (other float types are cast to it and back)."""
    x = img.float()
    sd = x.ndim - 2
    radius = filter_radius(spatial_sigma, truncate)
    padded = edge_pad(x, (radius,) * sd)
    spatial = x.shape[2:]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    w_s = spatial_weights(float(spatial_sigma), radius, sd)
    for t, off in enumerate(itertools.product(range(-radius, radius + 1), repeat=sd)):
        shifted = padded[(slice(None), slice(None)) + tuple(slice(radius + o, radius + o + s)
                                                            for o, s in zip(off, spatial))]
        w = torch.exp(-0.5 * ((shifted - x) / color_sigma) ** 2).mul_(float(w_s[t]))
        num.add_(w * shifted)
        den.add_(w)
    return (num / den.clamp_(min=1e-8)).to(img.dtype)


@functools.lru_cache(maxsize=64)
def _device_weights(spatial_sigma: float, radius: int, sd: int, device: torch.device) -> torch.Tensor:
    """``spatial_weights(...)`` on ``device``, kept there: a path filters with the same
    sigma again and again."""
    return torch.from_numpy(spatial_weights(spatial_sigma, radius, sd).copy()).to(device)


@functools.cache
def _launcher():
    fn = library().monai_bilateral_filter
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bilateral_stencil(img: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
                      truncate: float = 2.0) -> torch.Tensor:
    """Bilateral filter of a CUDA tensor (B, C, H, W) or (B, C, D, H, W) on the CUDA kernel,
    at any radius; adds one to ``bilateral_stencil.launches``. Float types other than
    float32 are cast to float32 and back; a non-contiguous input is copied."""
    if not isinstance(img, torch.Tensor) or img.ndim not in (4, 5):
        raise ValueError(f"bilateral_stencil takes a (B, C, H, W) or (B, C, D, H, W) tensor; got "
                         f"{tuple(img.shape) if isinstance(img, torch.Tensor) else type(img)}")
    if torch.is_grad_enabled() and img.requires_grad:
        raise RuntimeError("bilateral_stencil is forward-only; run it under torch.inference_mode()")
    if img.device.type != "cuda":
        raise ValueError(f"bilateral_stencil runs on CUDA tensors, not {img.device}; "
                         "bilateral_filter takes the plain version elsewhere")
    if not img.dtype.is_floating_point:
        raise TypeError(f"bilateral_stencil takes a floating tensor; got {img.dtype}")
    if min(img.shape) <= 0:
        raise ValueError(f"bilateral_stencil takes a non-empty tensor; got {tuple(img.shape)}")
    sd = img.ndim - 2
    x = img.to(torch.float32).contiguous()
    radius = filter_radius(spatial_sigma, truncate)
    spatial = tuple(int(s) for s in x.shape[2:])
    dims = spatial if sd == 3 else (1, *spatial)
    weights = _device_weights(float(spatial_sigma), radius, sd, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), out.data_ptr(), weights.data_ptr(), x.shape[0] * x.shape[1], sd, *dims,
                          radius, 0.5 / float(color_sigma) ** 2, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilateral_stencil: CUDA launch failed with error {err} "
                           f"({tuple(img.shape)}, radius {radius})")
    bilateral_stencil.launches += 1
    return out.to(img.dtype)


bilateral_stencil.launches = 0
