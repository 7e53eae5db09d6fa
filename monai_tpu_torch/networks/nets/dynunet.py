"""DynUNet, nnU-Net's network (counterpart of monai_tpu/networks/nets/dynunet.py).

An encoder of ``UnetBasicBlock``s (or ``UnetResBlock``s where ``res_block``), one a stage
(``input_block``, ``downsamples``, ``bottleneck``), the first conv of each at the stage's
stride, and a decoder of ``UnetUpBlock``s (``upsamples``) back to ``output_block``'s 1x1
conv. Each stride-1 3x3x3 conv runs kernel 1 (``ops/conv3d.py``), each instance norm and the
LeakyReLU after it kernel B2 (``instance_norm_prelu``); the strided and transposed convs
run cuDNN in full float32. Module names are torch MONAI's.

As the JAX net: the decoder block of stage ``i`` takes ``kernel_size[i]`` (torch MONAI's
takes ``kernel_size[i + 1]``), and with ``deep_supervision`` the output is the stack on
axis 1 of the main output and ``deep_supr_num`` heads (a 1x1 conv on the decoder's
outputs before the last, resized to the main output's size by nearest neighbours, the
index ``jax.image.resize`` picks), in train and eval mode alike (torch MONAI's returns the
main output alone in eval mode).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.backend import resolve_device
from ..blocks.dynunet_block import UnetBasicBlock, UnetOutBlock, UnetResBlock, UnetUpBlock

__all__ = ["DynUNet", "DynUNetSkipLayer"]


class DynUNet(nn.Module):
    """``device=None`` is the CUDA card (``utils.backend.resolve_device``); pass
    ``device="cpu"`` for the CPU. The weights are drawn on the CPU from ``generator`` (or
    torch's global seed) and then moved. ``filters`` defaults to 32 doubling a stage, at
    most 320 (3-D) or 512 (2-D). ``dropout`` is taken and no dropout is applied, in train
    mode as in eval mode, as in the JAX net (whose blocks take ``dropout=None`` whatever it
    says); torch MONAI's blocks drop after each norm."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, kernel_size: Sequence,
                 strides: Sequence, upsample_kernel_size: Sequence, filters: Sequence[int] | None = None,
                 dropout=None, norm_name=("INSTANCE", {"affine": True}),
                 act_name=("leakyrelu", {"negative_slope": 0.01}), deep_supervision: bool = False,
                 deep_supr_num: int = 1, res_block: bool = False, trans_bias: bool = False, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        n = len(strides)
        if len(kernel_size) != n or len(upsample_kernel_size) != n - 1 or n < 3:
            raise ValueError("DynUNet takes a kernel_size a stage, one upsample_kernel_size a stage but the first, "
                             "and at least 3 stages")
        if deep_supervision and not 1 <= deep_supr_num < n - 1:
            raise ValueError(f"deep_supr_num should be in [1, {n - 2}], got {deep_supr_num}")
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.strides = strides
        self.upsample_kernel_size = upsample_kernel_size
        self.deep_supervision = deep_supervision
        self.deep_supr_num = deep_supr_num
        if filters is None:
            filters = [min(2 ** (5 + i), 320 if spatial_dims == 3 else 512) for i in range(n)]
        self.filters = list(filters)
        device = resolve_device(device)
        made = dict(device="cpu", dtype=dtype, generator=generator)
        block = UnetResBlock if res_block else UnetBasicBlock

        def stage(cin: int, cout: int, i: int) -> nn.Module:
            return block(spatial_dims, cin, cout, kernel_size[i], strides[i], norm_name, act_name, **made)

        self.input_block = stage(in_channels, filters[0], 0)
        self.downsamples = nn.ModuleList(stage(filters[i - 1], filters[i], i) for i in range(1, n - 1))
        self.bottleneck = stage(filters[-2], filters[-1], n - 1)
        self.upsamples = nn.ModuleList(
            UnetUpBlock(spatial_dims, filters[-1 - i], filters[-2 - i], kernel_size[-2 - i], strides[-1 - i],
                        upsample_kernel_size[-1 - i], norm_name, act_name, trans_bias=trans_bias, **made)
            for i in range(n - 1))
        self.output_block = UnetOutBlock(spatial_dims, filters[0], out_channels, **made)
        if deep_supervision:  # head i reads the decoder's output with filters[i + 1] channels
            self.deep_supervision_heads = nn.ModuleList(
                UnetOutBlock(spatial_dims, filters[i + 1], out_channels, **made) for i in range(deep_supr_num))
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = [self.input_block(x)]
        for down in self.downsamples:
            skips.append(down(skips[-1]))
        x = self.bottleneck(skips[-1])
        decoded = []
        for i, up in enumerate(self.upsamples):
            x = up(x, skips[-1 - i])
            decoded.append(x)
        out = self.output_block(x)
        if not self.deep_supervision:
            return out
        heads = [F.interpolate(head(decoded[-2 - i]), size=out.shape[2:], mode="nearest-exact")
                 for i, head in enumerate(self.deep_supervision_heads)]
        return torch.stack([out, *heads], dim=1)


class DynUNetSkipLayer(nn.Module):
    """A recursive skip layer for custom topologies: ``downsample``, then ``next_layer``,
    then ``upsample`` of that with the downsampled input as its skip; where ``super_head``
    and ``heads`` are given and ``index`` > 0, ``heads[index - 1]`` gets the head of the
    upsampled output."""

    def __init__(self, index: int, downsample: nn.Module, upsample: nn.Module, next_layer: nn.Module,
                 heads: list | None = None, super_head: nn.Module | None = None):
        super().__init__()
        self.downsample = downsample
        self.next_layer = next_layer
        self.upsample = upsample
        self.super_head = super_head
        self.heads = heads
        self.index = index

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        downout = self.downsample(x)
        upout = self.upsample(self.next_layer(downout), downout)
        if self.super_head is not None and self.heads is not None and self.index > 0:
            self.heads[self.index - 1] = self.super_head(upout)
        return upout
