"""DynUNet-style conv blocks (counterpart of monai_tpu/networks/blocks/dynunet_block.py,
for the blocks DynUNet, SwinUNETR and UNETR use), with torch
MONAI's module names: a block holds ``conv1``, ``conv2`` (and ``conv3`` on the
downsampling path), ``norm1``, ``norm2`` (``norm3``) and ``lrelu``; every conv is a
``Convolution`` with only a ``conv`` child, so its weight is ``conv1.conv.weight``.

Where the norm is the port's instance norm and the activation a LeakyReLU, ``norm1``
and the LeakyReLU after it run as one ``instance_norm_prelu`` launch, the slope held in
a non-persistent buffer so the ``state_dict`` keys stay torch MONAI's. ``norm2`` and
``norm3`` run without a slope; the residual add and the last LeakyReLU are plain torch.
Activations stay in channels-last memory.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..layers.factories import get_act_layer, get_norm_layer
from ..layers.fast_norm import InstanceNorm, channels_last
from .convolutions import Convolution

__all__ = ["UnetBasicBlock", "UnetResBlock", "UnetUpBlock", "UnetOutBlock", "UnetrBasicBlock", "UnetrPrUpBlock",
           "UnetrUpBlock", "get_conv_layer", "get_output_padding", "get_padding"]

_LRELU = ("leakyrelu", {"negative_slope": 0.01})
_INSTANCE_AFFINE = ("instance", {"affine": True})


def get_padding(kernel_size, stride):
    """SAME-style padding for the given kernel and stride."""
    pad_np = (np.atleast_1d(kernel_size) - np.atleast_1d(stride) + 1) / 2
    if np.min(pad_np) < 0:
        raise AssertionError("padding value should not be negative, please change the kernel size and/or stride.")
    padding = tuple(int(p) for p in pad_np)
    return padding if len(padding) > 1 else padding[0]


def get_output_padding(kernel_size, stride, padding):
    """Transposed-conv output padding that makes the output ``stride`` times the input."""
    out_np = 2 * np.atleast_1d(padding) + np.atleast_1d(stride) - np.atleast_1d(kernel_size)
    if np.min(out_np) < 0:
        raise AssertionError("out_padding value should not be negative, please change the kernel size and/or stride.")
    out_padding = tuple(int(p) for p in out_np)
    return out_padding if len(out_padding) > 1 else out_padding[0]


def get_conv_layer(spatial_dims: int, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                   bias: bool = False, is_transposed: bool = False, device=None, dtype=None,
                   generator: torch.Generator | None = None) -> Convolution:
    """A conv-only ``Convolution``: SAME padding, or for a transposed conv an output
    ``stride`` times its input."""
    padding = get_padding(kernel_size, stride)
    output_padding = get_output_padding(kernel_size, stride, padding) if is_transposed else None
    return Convolution(spatial_dims, in_channels, out_channels, strides=stride, kernel_size=kernel_size,
                       bias=bias, conv_only=True, is_transposed=is_transposed, padding=padding,
                       output_padding=output_padding, device=device, dtype=dtype, generator=generator)


class _NormActMixin:
    """``norm`` then the block's LeakyReLU, in one launch where the two fuse."""

    def _init_fused_slope(self, device, dtype) -> None:
        self.fuse_lrelu = isinstance(self.norm1, InstanceNorm) and isinstance(self.lrelu, nn.LeakyReLU)
        if self.fuse_lrelu:
            self.register_buffer("lrelu_slope", torch.full((1,), self.lrelu.negative_slope, device=device,
                                                           dtype=dtype), persistent=False)

    def _norm_act(self, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_lrelu:
            return norm(x, self.lrelu_slope)
        return self.lrelu(norm(x))


class UnetBasicBlock(_NormActMixin, nn.Module):
    """Two conv → norm → LeakyReLU."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 norm_name=_INSTANCE_AFFINE, act_name=_LRELU, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        conv = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = get_conv_layer(spatial_dims, in_channels, out_channels, kernel_size, stride, **conv)
        self.conv2 = get_conv_layer(spatial_dims, out_channels, out_channels, kernel_size, 1, **conv)
        self.lrelu = get_act_layer(act_name)
        self.norm1 = get_norm_layer(norm_name, spatial_dims, out_channels, device=device, dtype=dtype)
        self.norm2 = get_norm_layer(norm_name, spatial_dims, out_channels, device=device, dtype=dtype)
        self._init_fused_slope(device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm_act(self.norm1, self.conv1(x))
        return self._norm_act(self.norm2, self.conv2(x))


class UnetResBlock(_NormActMixin, nn.Module):
    """conv → norm → LeakyReLU → conv → norm, plus the input (through a 1x1 conv and a
    norm where the channels or the stride change), then LeakyReLU."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 norm_name=_INSTANCE_AFFINE, act_name=_LRELU, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        conv = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = get_conv_layer(spatial_dims, in_channels, out_channels, kernel_size, stride, **conv)
        self.conv2 = get_conv_layer(spatial_dims, out_channels, out_channels, kernel_size, 1, **conv)
        self.lrelu = get_act_layer(act_name)
        self.norm1 = get_norm_layer(norm_name, spatial_dims, out_channels, device=device, dtype=dtype)
        self.norm2 = get_norm_layer(norm_name, spatial_dims, out_channels, device=device, dtype=dtype)
        self.downsample = in_channels != out_channels or bool(np.any(np.atleast_1d(stride) != 1))
        if self.downsample:
            self.conv3 = get_conv_layer(spatial_dims, in_channels, out_channels, 1, stride, **conv)
            self.norm3 = get_norm_layer(norm_name, spatial_dims, out_channels, device=device, dtype=dtype)
        self._init_fused_slope(device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._norm_act(self.norm1, self.conv1(x))
        out = self.norm2(self.conv2(out))
        residual = self.norm3(self.conv3(x)) if self.downsample else x
        return self.lrelu(out + residual)


class UnetUpBlock(nn.Module):
    """DynUNet's decoder block: a transposed conv of kernel and stride
    ``upsample_kernel_size`` (with a bias where ``trans_bias``), the skip concatenated
    after it, then a ``UnetBasicBlock`` of ``kernel_size``."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 upsample_kernel_size=2, norm_name=_INSTANCE_AFFINE, act_name=_LRELU, trans_bias: bool = False,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.transp_conv = get_conv_layer(spatial_dims, in_channels, out_channels, upsample_kernel_size,
                                          upsample_kernel_size, bias=trans_bias, is_transposed=True, device=device,
                                          dtype=dtype, generator=generator)
        self.conv_block = UnetBasicBlock(spatial_dims, out_channels * 2, out_channels, kernel_size, 1, norm_name,
                                         act_name, device=device, dtype=dtype, generator=generator)

    def forward(self, inp: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(channels_last(torch.cat((self.transp_conv(inp), skip), dim=1)))


class UnetOutBlock(nn.Module):
    """1x1 conv with bias to the output channels."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = get_conv_layer(spatial_dims, in_channels, out_channels, kernel_size=1, stride=1, bias=True,
                                   device=device, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetrBasicBlock(nn.Module):
    """UNETR encoder block: a ``UnetResBlock`` or a ``UnetBasicBlock`` as ``layer``."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 norm_name=_INSTANCE_AFFINE, res_block: bool = True, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        block = UnetResBlock if res_block else UnetBasicBlock
        self.layer = block(spatial_dims, in_channels, out_channels, kernel_size, stride, norm_name,
                           device=device, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """UNETR decoder block: transposed-conv upsample, concatenate the skip, conv block."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, kernel_size=3,
                 upsample_kernel_size=2, norm_name=_INSTANCE_AFFINE, res_block: bool = True, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.transp_conv = get_conv_layer(spatial_dims, in_channels, out_channels, upsample_kernel_size,
                                          upsample_kernel_size, is_transposed=True, device=device, dtype=dtype,
                                          generator=generator)
        block = UnetResBlock if res_block else UnetBasicBlock
        self.conv_block = block(spatial_dims, out_channels + out_channels, out_channels, kernel_size, 1, norm_name,
                                device=device, dtype=dtype, generator=generator)

    def forward(self, inp: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        out = channels_last(torch.cat((self.transp_conv(inp), skip), dim=1))
        return self.conv_block(out)


class UnetrPrUpBlock(nn.Module):
    """UNETR's projection upsampling: ``transp_conv_init``, then ``num_layer`` more transposed
    convs (``blocks.<i>``), each followed where ``conv_block`` by a ``UnetResBlock`` (or a
    ``UnetBasicBlock`` without ``res_block``) of ``kernel_size``, the pair a ``Sequential``
    (``blocks.<i>.0``, ``blocks.<i>.1``) as in torch MONAI. Every transposed conv has kernel =
    stride = ``upsample_kernel_size``, as the JAX package's ``get_conv_layer`` gives it;
    ``stride`` is taken and unused, as there."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, num_layer: int, kernel_size=3,
                 stride=1, upsample_kernel_size=2, norm_name=_INSTANCE_AFFINE, conv_block: bool = False,
                 res_block: bool = False, device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        made = dict(device=device, dtype=dtype, generator=generator)

        def up(cin: int) -> Convolution:
            return get_conv_layer(spatial_dims, cin, out_channels, upsample_kernel_size, upsample_kernel_size,
                                  is_transposed=True, **made)

        self.transp_conv_init = up(in_channels)
        block = UnetResBlock if res_block else UnetBasicBlock
        self.blocks = nn.ModuleList(
            nn.Sequential(up(out_channels), block(spatial_dims, out_channels, out_channels, kernel_size, 1, norm_name,
                                                  **made)) if conv_block else up(out_channels)
            for _ in range(num_layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transp_conv_init(x)
        for blk in self.blocks:
            x = blk(channels_last(x))
        return x
