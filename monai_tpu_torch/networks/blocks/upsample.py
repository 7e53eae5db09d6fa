"""Upsampling (counterpart of monai_tpu/networks/blocks/upsample.py): ``UpSample`` in its
``deconv``, ``nontrainable`` (``interp`` is the same) and ``pixelshuffle`` modes,
``SubpixelUpsample`` and ``interpolate``.

``interpolate`` computes what the JAX package's ``jax.image.resize`` computes (its default
``antialias=True``). ``nearest`` picks source index floor((i + 0.5) * in / out), which is
``F.interpolate``'s ``nearest-exact``; a linear mode that enlarges every axis samples at
half-pixel centres, which is ``F.interpolate`` with ``align_corners=False`` whatever
``align_corners`` says (the JAX function ignores it too). Every other case is a weight
matrix an axis, built on the host in float64 as ``jax.image.resize`` builds it
(``_resize_weights``) and applied on the device by ``tensordot``: a linear mode that
shrinks an axis widens its triangle by in/out (antialiasing); ``area`` is that antialiased
linear, not torch's adaptive average; ``bicubic`` (and ``cubic``) is Keys' kernel at
a = -0.5 (torch's bicubic takes -0.75 and clamps at the border), also widened on shrink.
Each output sample's weights are renormalised to sum to 1, and a sample outside
[-0.5, in - 0.5] of the input is 0.

``deconv`` is a transposed conv of kernel ``kernel_size or scale_factor`` at stride
``scale_factor`` aligned as ``lax.conv_transpose``'s ``"SAME"`` padding, the JAX factory's
(``_same_transpose_crop``): the output is ``scale_factor`` times the input, where torch
MONAI's is (n - 1) s + k. ``pixelshuffle`` is ``SubpixelUpsample``, which shuffles in the
JAX module's channel order, not ``pixelshuffle``'s (see its docstring).
"""
from __future__ import annotations

from collections.abc import Sequence
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.backend import full_float32
from ...utils.misc import ensure_tuple_rep
from ..layers.factories import Conv

__all__ = ["SubpixelUpsample", "UpSample", "interpolate"]

_LINEAR = {"linear", "bilinear", "trilinear"}
_CUBIC = {"bicubic", "cubic", "tricubic"}


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel at a = -0.5 of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@lru_cache(maxsize=256)
def _resize_weights(in_size: int, out_size: int, cubic: bool) -> np.ndarray:
    """The (in_size, out_size) float64 matrix that ``jax.image.resize`` applies along an axis
    (``jax/_src/image/scale.py::compute_weight_mat``, translation 0, antialiased)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)  # widen the kernel when shrinking
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = (_keys_cubic if cubic else _triangle)(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _resize_by_weights(x: torch.Tensor, size: tuple[int, ...], cubic: bool) -> torch.Tensor:
    """Each spatial axis whose size changes contracted with its ``_resize_weights`` matrix."""
    with full_float32(x):
        for i, (n_in, n_out) in enumerate(zip(x.shape[2:], size)):
            if n_in == n_out:
                continue
            w = torch.from_numpy(_resize_weights(n_in, n_out, cubic)).to(x.device, x.dtype)
            x = torch.tensordot(x, w, dims=([2 + i], [0])).movedim(-1, 2 + i)
    return x


def interpolate(x: torch.Tensor, scale_factor=None, size=None, mode: str = "nearest") -> torch.Tensor:
    """Resize the spatial axes of a channel-first (B, C, *spatial) tensor to ``size``, or to
    round(spatial * ``scale_factor``)."""
    spatial = x.shape[2:]
    if size is None:
        size = tuple(int(round(s * f)) for s, f in zip(spatial, ensure_tuple_rep(scale_factor, len(spatial))))
    size = tuple(int(s) for s in ensure_tuple_rep(size, len(spatial)))
    if mode == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    if mode in _LINEAR and all(o >= i for o, i in zip(size, spatial)):
        return F.interpolate(x, size=size, mode=("linear", "bilinear", "trilinear")[len(spatial) - 1],
                             align_corners=False)
    if mode in _LINEAR or mode == "area" or mode in _CUBIC:
        return _resize_by_weights(x, size, mode in _CUBIC)
    raise NotImplementedError(f"interpolate: mode {mode!r} is not one of nearest, the linear modes, area and "
                              f"the cubic modes")


def _same_transpose_crop(kernel: int, stride: int, n: int) -> tuple[int, int]:
    """(start, length) of the JAX ``"SAME"`` transposed conv's output along an axis of ``n``
    inside torch's unpadded one (padding 0, output padding max(stride - kernel, 0)):
    ``lax.conv_transpose`` pads the stride-dilated input by (a, k + s - 2 - a), a = k - 1
    where s > k - 1 and ceil((k + s - 2) / 2) otherwise, which is torch's full output from
    k - 1 - a on, n s long."""
    a = kernel - 1 if stride > kernel - 1 else -(-(kernel + stride - 2) // 2)
    return kernel - 1 - a, n * stride


class UpSample(nn.Module):
    """Upsample by ``scale_factor`` (or, not trainable, to ``size``). ``deconv``: a transposed
    conv (``deconv``) of kernel ``kernel_size or scale_factor`` at stride ``scale_factor``,
    output ``scale_factor`` times the input. ``nontrainable``/``interp``: ``interpolate`` at
    ``interp_mode``, after a 1x1 conv (``preconv``) from ``in_channels`` to ``out_channels``
    where they differ and ``pre_conv`` is ``"default"`` (a module given as ``pre_conv`` runs
    instead; None runs none). ``pixelshuffle``: ``SubpixelUpsample`` (``pixelshuffle``) with
    ``pre_conv`` as its conv block. ``align_corners`` is taken and ignored, as in the JAX
    package."""

    def __init__(self, spatial_dims: int, in_channels: int | None = None, out_channels: int | None = None,
                 scale_factor: Sequence[float] | float = 2, kernel_size=None, size=None, mode: str = "deconv",
                 pre_conv="default", interp_mode: str = "linear", align_corners: bool = True, bias: bool = True,
                 apply_pad_pool: bool = True, device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.mode = mode.lower()
        self.scale_factor = ensure_tuple_rep(scale_factor, spatial_dims)
        self.size = size
        self.interp_mode = interp_mode
        out_channels = out_channels or in_channels
        made = dict(device=device, dtype=dtype, generator=generator)
        self.preconv: nn.Module | None = None
        if self.mode == "deconv":
            stride = tuple(int(s) for s in self.scale_factor)
            kernel = ensure_tuple_rep(kernel_size or stride, spatial_dims)
            self.deconv_kernel, self.deconv_stride = kernel, stride
            self.deconv = Conv[Conv.CONVTRANS, spatial_dims](
                in_channels, out_channels, kernel_size=kernel, stride=stride,
                output_padding=tuple(max(s - k, 0) for k, s in zip(kernel, stride)), bias=bias, **made)
        elif self.mode in ("nontrainable", "interp"):
            if pre_conv == "default" and in_channels != out_channels:
                self.preconv = Conv[Conv.CONV, spatial_dims](in_channels, out_channels, kernel_size=1, bias=bias,
                                                             **made)
            elif isinstance(pre_conv, nn.Module):
                self.preconv = pre_conv
        elif self.mode == "pixelshuffle":
            self.pixelshuffle = SubpixelUpsample(spatial_dims, in_channels, out_channels, int(self.scale_factor[0]),
                                                 conv_block=pre_conv, apply_pad_pool=apply_pad_pool, bias=bias, **made)
        else:
            raise NotImplementedError(f"Unsupported upsampling mode {mode}.")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "deconv":
            n = x.shape[2:]
            y = self.deconv(x)
            crops = [_same_transpose_crop(k, s, m) for k, s, m in zip(self.deconv_kernel, self.deconv_stride, n)]
            if any(start or length != full for (start, length), full in zip(crops, y.shape[2:])):
                y = y[(slice(None), slice(None), *(slice(start, start + length) for start, length in crops))]
            return y
        if self.mode == "pixelshuffle":
            return self.pixelshuffle(x)
        if self.preconv is not None:
            x = self.preconv(x)
        return interpolate(x, scale_factor=self.scale_factor, size=self.size, mode=self.interp_mode)


class SubpixelUpsample(nn.Module):
    """``conv_block`` (default: a 3x3x3 SAME conv with bias from ``in_channels`` to
    ``out_channels * scale_factor ** spatial_dims``; None: none; or a module), then a pixel
    shuffle by ``scale_factor``. The shuffle is the JAX module's: its conv's output channels
    are read channel-last with the output channel fastest, so output channel c at offsets
    (r_1, ..., r_d) reads channel ((r_1 f + r_2) f + ...) C + c, where torch MONAI's and
    ``pixelshuffle`` read c f^d + (r_1 f + r_2) f + ...; a conv carried over by the weight
    bridge keeps its output channels as they are, so the port follows the JAX order.
    ``apply_pad_pool`` is taken and not applied, as in the JAX module."""

    def __init__(self, spatial_dims: int, in_channels: int | None, out_channels: int | None = None,
                 scale_factor: int = 2, conv_block="default", apply_pad_pool: bool = True, bias: bool = True,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.spatial_dims = spatial_dims
        self.scale_factor = scale_factor
        out_channels = out_channels or in_channels
        self.conv_block: nn.Module | None
        if conv_block == "default":
            self.conv_block = Conv[Conv.CONV, spatial_dims](in_channels, out_channels * scale_factor**spatial_dims,
                                                            kernel_size=3, padding=1, bias=bias, device=device,
                                                            dtype=dtype, generator=generator)
        elif conv_block is None:
            self.conv_block = None
        else:
            self.conv_block = conv_block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_block is not None:
            x = self.conv_block(x)
        b, channels, *spatial = x.shape
        r, d = self.scale_factor, self.spatial_dims
        c = channels // r**d
        x = x.reshape(b, *(r,) * d, c, *spatial)  # channel ((r_1 r + r_2) r + ...) c + c_out
        x = x.permute(0, 1 + d, *(i for k in range(d) for i in (2 + d + k, 1 + k)))  # (b, c, s_1, r_1, ...)
        return x.reshape(b, c, *(s * r for s in spatial))
