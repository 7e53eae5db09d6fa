"""SegResNet's building blocks (counterpart of monai_tpu/networks/blocks/segresnet_block.py):
``get_conv_layer``, ``get_upsample_layer`` and ``ResBlock`` (which the JAX package keeps
with the net and torch MONAI here; ``nets/segresnet.py`` exports it too).

``get_conv_layer`` is ``dynunet_block``'s: a conv-only ``Convolution`` whose padding,
(kernel_size - stride + 1) // 2, is kernel_size // 2 at SegResNet's kernels and strides (3
at stride 1 or 2, 1 at stride 1); a 3x3x3 stride-1 one runs kernel 1, any other cuDNN."""
from __future__ import annotations

import torch
from torch import nn

from ..layers.factories import get_act_layer, get_norm_layer
from .dynunet_block import get_conv_layer
from .upsample import UpSample

__all__ = ["ResBlock", "get_conv_layer", "get_upsample_layer"]


def get_upsample_layer(spatial_dims: int, in_channels: int, upsample_mode: str = "nontrainable",
                       scale_factor: int = 2, device=None, dtype=None,
                       generator: torch.Generator | None = None) -> UpSample:
    """The JAX package's preset: ``UpSample`` at ``interp_mode="linear"``. (Its SegResNet
    builds its own, at ``"nearest"``.)"""
    return UpSample(spatial_dims, in_channels, in_channels, scale_factor=scale_factor, mode=upsample_mode,
                    interp_mode="linear", align_corners=False, device=device, dtype=dtype, generator=generator)


class ResBlock(nn.Module):
    """norm, act, conv, twice, plus the input: the convs ``kernel_size`` at stride 1,
    without bias."""

    def __init__(self, spatial_dims: int, in_channels: int, norm, kernel_size: int = 3, act=("RELU", {"inplace": True}),
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise AssertionError("kernel_size should be an odd number.")
        self.norm1 = get_norm_layer(norm, spatial_dims, in_channels, device=device, dtype=dtype)
        self.norm2 = get_norm_layer(norm, spatial_dims, in_channels, device=device, dtype=dtype)
        self.act = get_act_layer(act)
        conv = dict(kernel_size=kernel_size, device=device, dtype=dtype, generator=generator)
        self.conv1 = get_conv_layer(spatial_dims, in_channels, in_channels, **conv)
        self.conv2 = get_conv_layer(spatial_dims, in_channels, in_channels, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        x = self.conv1(self.act(self.norm1(x)))
        x = self.conv2(self.act(self.norm2(x)))
        return x + identity
