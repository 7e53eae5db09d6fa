"""Upsampling (counterpart of monai_tpu/networks/blocks/upsample.py): ``UpSample`` in its
``nontrainable`` mode (``interp`` is the same), with its 1x1 pre-convolution rule, and
``interpolate``.

``interpolate`` computes what the JAX package's ``jax.image.resize`` computes when it
enlarges: ``nearest`` picks source index floor((i + 0.5) * in / out), which is
``F.interpolate``'s ``nearest-exact`` (i // f for an integer factor f); the linear modes
sample at half-pixel centres, which is ``F.interpolate`` with ``align_corners=False``
whatever ``align_corners`` says (the JAX function ignores it too). Shrinking with a linear
mode (``jax.image.resize`` then antialiases) and the cubic and area modes raise. The
``deconv`` and ``pixelshuffle`` modes are not ported and raise, naming the ROADMAP item
(A7, 'What the shipped slices left').
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.misc import ensure_tuple_rep
from ..layers.factories import Conv

__all__ = ["UpSample", "interpolate"]

_LINEAR = {"linear", "bilinear", "trilinear"}


def interpolate(x: torch.Tensor, scale_factor=None, size=None, mode: str = "nearest") -> torch.Tensor:
    """Resize the spatial axes of a channel-first (B, C, *spatial) tensor to ``size``, or to
    round(spatial * ``scale_factor``)."""
    spatial = x.shape[2:]
    if size is None:
        size = tuple(int(round(s * f)) for s, f in zip(spatial, ensure_tuple_rep(scale_factor, len(spatial))))
    size = tuple(int(s) for s in ensure_tuple_rep(size, len(spatial)))
    if mode == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    if mode in _LINEAR:
        if any(o < i for o, i in zip(size, spatial)):
            raise NotImplementedError("interpolate: a linear mode that shrinks an axis antialiases in the JAX "
                                      "package, which the port does not do")
        return F.interpolate(x, size=size, mode=("linear", "bilinear", "trilinear")[len(spatial) - 1],
                             align_corners=False)
    raise NotImplementedError(f"interpolate: mode {mode!r} is not ported (nearest and the linear modes are)")


class UpSample(nn.Module):
    """Upsample by ``scale_factor`` (or to ``size``) with ``interpolate``, after a 1x1 conv
    from ``in_channels`` to ``out_channels`` where they differ and ``pre_conv`` is
    ``"default"`` (a module given as ``pre_conv`` runs instead; None runs none)."""

    def __init__(self, spatial_dims: int, in_channels: int | None = None, out_channels: int | None = None,
                 scale_factor: Sequence[float] | float = 2, kernel_size=None, size=None, mode: str = "deconv",
                 pre_conv="default", interp_mode: str = "linear", align_corners: bool = True, bias: bool = True,
                 apply_pad_pool: bool = True, device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.mode = mode.lower()
        if self.mode not in ("nontrainable", "interp"):
            raise NotImplementedError(f"UpSample mode {mode!r} is not ported (ROADMAP A item 7, 'What the shipped "
                                      "slices left'); 'nontrainable' is")
        self.scale_factor = ensure_tuple_rep(scale_factor, spatial_dims)
        self.size = size
        self.interp_mode = interp_mode
        out_channels = out_channels or in_channels
        self.preconv: nn.Module | None = None
        if pre_conv == "default" and in_channels != out_channels:
            self.preconv = Conv[Conv.CONV, spatial_dims](in_channels, out_channels, kernel_size=1, bias=bias,
                                                         device=device, dtype=dtype, generator=generator)
        elif isinstance(pre_conv, nn.Module):
            self.preconv = pre_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.preconv is not None:
            x = self.preconv(x)
        return interpolate(x, scale_factor=self.scale_factor, size=self.size, mode=self.interp_mode)
