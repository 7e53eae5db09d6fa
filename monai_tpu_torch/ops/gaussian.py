"""Separable N-D Gaussian (and generic separable) filtering of channel-first tensors
(counterpart of monai_tpu/ops/gaussian.py).

One 1-D correlation per spatial axis (``F.conv1d`` on the axis moved last), for any
number of axes: the bilateral grid blurs a 3-D image's grid over four, which the JAX
package's ``lax.conv_general_dilated`` helper does not take. A float32 CUDA tensor's
correlations run in full float32 whatever torch's TF32 setting (``full_float32``).
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.backend import full_float32
from ..utils.misc import ensure_tuple_rep

__all__ = ["gaussian_1d", "gaussian_filter", "separable_filtering"]


def gaussian_1d(sigma: float, truncated: float = 4.0, approx: str = "erf", normalize: bool = True) -> np.ndarray:
    """1-D float32 Gaussian kernel of 2·int(max(sigma·truncated, 0.5) + 0.5) + 1 taps:
    'erf' integrates the Gaussian over each voxel, 'sampled' samples it, 'scalespace'
    is the discrete scale-space kernel (modified Bessel functions)."""
    sigma = float(sigma)
    if sigma <= 0 or truncated <= 0:
        raise ValueError(f"sigma and truncated must be positive, got {sigma} and {truncated}.")
    tail = int(max(sigma * truncated, 0.5) + 0.5)
    x = np.arange(-tail, tail + 1, dtype=np.float64)
    if approx == "erf":
        from scipy.special import erf

        t = 0.70710678 / sigma
        out = np.clip(0.5 * (erf((x + 0.5) * t) - erf((x - 0.5) * t)), a_min=0, a_max=None)
    elif approx == "sampled":
        out = np.exp(-0.5 / (sigma * sigma) * x ** 2)
        if not normalize:
            out = out / (2.5066282 * sigma)
    elif approx == "scalespace":
        from scipy.special import ive

        out = ive(np.abs(x), sigma * sigma)
    else:
        raise NotImplementedError(f"Unsupported option: approx='{approx}'.")
    if normalize and out.sum() > 0:
        out = out / out.sum()
    return out.astype(np.float32)


def _padded_index(n: int, before: int, after: int, mode: str) -> np.ndarray:
    """Source index of each position of an axis of length n padded by (before, after),
    as ``jnp.pad`` with 'reflect' (edge excluded), 'symmetric' (edge repeated), 'edge'
    or 'wrap' places it."""
    i = np.arange(-before, n + after)
    if mode == "edge" or n == 1:
        return np.clip(i, 0, n - 1)
    if mode == "wrap":
        return np.remainder(i, n)
    if mode == "reflect":
        m = np.remainder(i, 2 * (n - 1))
        return np.where(m >= n, 2 * (n - 1) - m, m)
    m = np.remainder(i, 2 * n)  # symmetric
    return np.where(m >= n, 2 * n - 1 - m, m)


_PAD_MODES = {"reflect": "reflect", "mirror": "reflect", "symmetric": "symmetric", "replicate": "edge",
              "border": "edge", "edge": "edge", "circular": "wrap", "wrap": "wrap"}


def separable_filtering(x: torch.Tensor, kernels: Sequence, mode: str = "zeros") -> torch.Tensor:
    """Correlate channel-first ``x`` (C, *spatial) with one 1-D kernel per spatial axis,
    in axis order; 'same' output. ``mode`` pads as torch names it ('reflect' excludes the
    edge, 'symmetric' repeats it, 'replicate', 'circular'); any other mode pads zeros.
    Float types other than float32, float64 and bfloat16 compute in float32."""
    nd = x.ndim - 1
    if len(kernels) != nd:
        raise ValueError(f"need {nd} kernels, got {len(kernels)}")
    pad_mode = _PAD_MODES.get(mode)
    out = x if x.dtype in (torch.float32, torch.float64, torch.bfloat16) else x.float()
    for axis, k in enumerate(kernels):
        k = torch.as_tensor(np.asarray(k, dtype=np.float32)).to(out.device, out.dtype)
        ksize = int(k.shape[0])
        if ksize == 1 and float(k[0]) == 1.0:
            continue
        before, after = ksize // 2, ksize - 1 - ksize // 2
        moved = out.movedim(axis + 1, -1)
        n = moved.shape[-1]
        if pad_mode is None:
            line = F.pad(moved.reshape(-1, 1, n), (before, after))
        else:
            idx = torch.from_numpy(_padded_index(n, before, after, pad_mode)).to(out.device)
            line = moved.index_select(-1, idx).reshape(-1, 1, n + ksize - 1)
        with full_float32(line):
            filtered = F.conv1d(line, k.view(1, 1, ksize)).reshape(moved.shape)
        out = filtered.movedim(-1, axis + 1)
    return out.contiguous()


def gaussian_filter(x: torch.Tensor, sigma: float | Sequence[float], truncated: float = 4.0,
                    approx: str = "erf") -> torch.Tensor:
    """Gaussian-smooth channel-first ``x`` along every spatial axis (zero padding); an
    axis with sigma 0 is left as it is."""
    sigmas = ensure_tuple_rep(sigma, x.ndim - 1)
    kernels = [gaussian_1d(s, truncated, approx) if s > 0 else np.ones(1, dtype=np.float32) for s in sigmas]
    return separable_filtering(x, kernels)
