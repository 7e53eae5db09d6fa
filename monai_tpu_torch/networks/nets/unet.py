"""UNet (counterpart of monai_tpu/networks/nets/unet.py).

The public API takes channel-first (B, C, *spatial) tensors. Inside, a 3-D net keeps
its activations in ``torch.channels_last_3d`` memory, so that every conv and norm
kernel reads a contiguous NDHWC tensor. Module names follow torch MONAI's nested
``Sequential`` (``model.0`` down, ``model.1.submodule`` the inner levels, ``model.2``
up), so its ``state_dict`` keys are torch MONAI's.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ...utils.backend import resolve_device
from ..blocks.convolutions import Convolution, ResidualUnit

__all__ = ["SkipConnection", "UNet", "Unet"]


class SkipConnection(nn.Module):
    """Combine the input with the submodule's output along the channel dimension."""

    def __init__(self, submodule: nn.Module, dim: int = 1, mode: str = "cat"):
        super().__init__()
        if mode not in ("cat", "add", "mul"):
            raise NotImplementedError(f"Unsupported mode {mode}.")
        self.submodule = submodule
        self.dim = dim
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.submodule(x)
        if self.mode == "cat":
            return torch.cat([x, y], dim=self.dim)
        if self.mode == "add":
            return x + y
        return x * y


class UNet(nn.Module):
    """Residual or plain UNet: each level is down → skip(inner levels) → up.

    ``device=None`` is the CUDA card (``utils.backend.resolve_device``); pass
    ``device="cpu"`` for the CPU. The weights are made on the CPU and then moved, so one
    seed (``generator``, or torch's global seed) gives the same weights on either
    device."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, channels: Sequence[int],
                 strides: Sequence[int], kernel_size: Sequence[int] | int = 3,
                 up_kernel_size: Sequence[int] | int = 3, num_res_units: int = 0, act="PRELU",
                 norm="INSTANCE", dropout: float = 0.0, bias: bool = True, adn_ordering: str = "NDA",
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        if len(channels) < 2:
            raise ValueError("the length of `channels` should be no less than 2.")
        if len(strides) < len(channels) - 1:
            raise ValueError("the length of `strides` should equal to `len(channels) - 1`.")
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.channels = channels
        self.strides = strides
        self.num_res_units = num_res_units
        device = resolve_device(device)
        common = dict(act=act, norm=norm, dropout=dropout, bias=bias, adn_ordering=adn_ordering,
                      device="cpu", dtype=dtype, generator=generator)

        def down_layer(inc: int, outc: int, s) -> nn.Module:
            if num_res_units > 0:
                return ResidualUnit(spatial_dims, inc, outc, strides=s, kernel_size=kernel_size,
                                    subunits=num_res_units, **common)
            return Convolution(spatial_dims, inc, outc, strides=s, kernel_size=kernel_size, **common)

        def up_layer(inc: int, outc: int, s, is_top: bool) -> nn.Module:
            conv = Convolution(spatial_dims, inc, outc, strides=s, kernel_size=up_kernel_size,
                               conv_only=is_top and num_res_units == 0, is_transposed=True, **common)
            if num_res_units > 0:
                ru = ResidualUnit(spatial_dims, outc, outc, strides=1, kernel_size=kernel_size, subunits=1,
                                  last_conv_only=is_top, **common)
                return nn.Sequential(conv, ru)
            return conv

        def create_block(inc: int, outc: int, chs: Sequence[int], strs: Sequence[int], is_top: bool):
            c, s = chs[0], strs[0]
            if len(chs) > 2:
                subblock = create_block(c, c, chs[1:], strs[1:], False)
                upc = c * 2
            else:
                subblock = down_layer(c, chs[1], 1)  # the bottom layer
                upc = c + chs[1]
            down = down_layer(inc, c, s)
            up = up_layer(upc, outc, s, is_top)
            return nn.Sequential(down, SkipConnection(subblock), up)

        self.model = create_block(in_channels, out_channels, channels, strides, True)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 5:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        return self.model(x)


Unet = UNet
