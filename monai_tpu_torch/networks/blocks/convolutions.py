"""Convolution + ResidualUnit blocks (counterpart of
monai_tpu/networks/blocks/convolutions.py), with torch MONAI's module names: a
``Convolution`` holds ``conv`` and ``adn``; a ``ResidualUnit`` holds ``conv.unit{i}``
and ``residual``."""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
from torch import nn

from ...utils.misc import ensure_tuple_rep
from ..layers.factories import Conv
from ..layers.fast_norm import channels_last, instance_norm_prelu
from .acti_norm import ADN

__all__ = ["Convolution", "ResidualUnit", "same_padding", "stride_minus_kernel_padding"]


def same_padding(kernel_size, dilation=1):
    """Padding that keeps the size of a stride-1 convolution."""
    kernel_size_np = np.atleast_1d(kernel_size)
    dilation_np = np.atleast_1d(dilation)
    if np.any((kernel_size_np - 1) * dilation % 2 == 1):
        raise NotImplementedError(
            f"Same padding not available for kernel_size={kernel_size_np} and dilation={dilation_np}.")
    padding_np = (kernel_size_np - 1) / 2 * dilation_np
    return tuple(int(p) for p in padding_np) if len(padding_np) > 1 else int(padding_np[0])


def stride_minus_kernel_padding(kernel_size, stride):
    out_padding_np = np.atleast_1d(stride) - np.atleast_1d(kernel_size)
    return tuple(int(p) for p in out_padding_np) if len(out_padding_np) > 1 else int(out_padding_np[0])


class Convolution(nn.Sequential):
    """conv, then norm / dropout / activation, optionally transposed.

    When the ADN block is instance norm → dropout(p=0) → PReLU, the forward runs the
    three as one ``instance_norm_prelu`` call with the slope fused in."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 strides: Sequence[int] | int = 1, kernel_size: Sequence[int] | int = 3,
                 adn_ordering: str = "NDA", act="PRELU", norm="INSTANCE", dropout=None,
                 dropout_dim: int = 1, dilation: Sequence[int] | int = 1, groups: int = 1,
                 bias: bool = True, conv_only: bool = False, is_transposed: bool = False,
                 padding: Sequence[int] | int | None = None, output_padding=None,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.is_transposed = is_transposed
        if padding is None:
            padding = same_padding(kernel_size, dilation)
        if is_transposed:
            # torch semantics: padding p and output_padding s + 2p - k, so that the
            # output is `stride` times the input
            if output_padding is None:
                ks = ensure_tuple_rep(kernel_size, spatial_dims)
                st = ensure_tuple_rep(strides, spatial_dims)
                pd = ensure_tuple_rep(padding, spatial_dims)
                output_padding = tuple(s + 2 * p - k for s, p, k in zip(st, pd, ks))
            conv = Conv[Conv.CONVTRANS, spatial_dims](
                in_channels, out_channels, kernel_size=kernel_size, stride=strides, padding=padding,
                output_padding=output_padding, groups=groups, bias=bias, dilation=dilation,
                device=device, dtype=dtype, generator=generator)
        else:
            conv = Conv[Conv.CONV, spatial_dims](
                in_channels, out_channels, kernel_size=kernel_size, stride=strides, padding=padding,
                dilation=dilation, groups=groups, bias=bias, device=device, dtype=dtype,
                generator=generator)
        self.add_module("conv", conv)
        self.fused_norm_prelu = False
        if not conv_only:
            adn = ADN(ordering=adn_ordering, in_channels=out_channels, act=act, norm=norm,
                      norm_dim=spatial_dims, dropout=dropout, dropout_dim=dropout_dim, device=device,
                      dtype=dtype)
            self.add_module("adn", adn)
            self.fused_norm_prelu = adn.is_norm_prelu()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.fused_norm_prelu:
            norm, act = self.adn.N, self.adn.A
            return instance_norm_prelu(channels_last(x), norm.weight, norm.bias, act.weight, norm.eps)
        if "adn" in self._modules:
            x = self.adn(x)
        return x


class ResidualUnit(nn.Module):
    """``subunits`` Convolutions plus a residual path (identity, or a conv where the
    stride or the channel count changes)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 strides: Sequence[int] | int = 1, kernel_size: Sequence[int] | int = 3,
                 subunits: int = 2, adn_ordering: str = "NDA", act="PRELU", norm="INSTANCE",
                 dropout=None, dropout_dim: int = 1, dilation: Sequence[int] | int = 1,
                 bias: bool = True, last_conv_only: bool = False, padding=None,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.conv = nn.Sequential()
        self.residual: nn.Module = nn.Identity()
        if padding is None:
            padding = same_padding(kernel_size, dilation)
        schannels, sstrides = in_channels, strides
        subunits = max(1, subunits)
        for su in range(subunits):
            unit = Convolution(spatial_dims, schannels, out_channels, strides=sstrides,
                               kernel_size=kernel_size, adn_ordering=adn_ordering, act=act, norm=norm,
                               dropout=dropout, dropout_dim=dropout_dim, dilation=dilation, bias=bias,
                               conv_only=last_conv_only and su == subunits - 1, padding=padding,
                               device=device, dtype=dtype, generator=generator)
            self.conv.add_module(f"unit{su:d}", unit)
            schannels, sstrides = out_channels, 1
        if np.prod(strides) != 1 or in_channels != out_channels:
            rkernel_size, rpadding = kernel_size, padding
            if np.prod(strides) == 1:
                rkernel_size, rpadding = 1, 0
            self.residual = Conv[Conv.CONV, spatial_dims](
                in_channels, out_channels, kernel_size=rkernel_size, stride=strides, padding=rpadding,
                bias=bias, device=device, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.residual(x)
