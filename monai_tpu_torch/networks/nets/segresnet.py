"""SegResNet (counterpart of monai_tpu/networks/nets/segresnet.py).

A residual encoder-decoder on channel-first (B, C, *spatial) tensors: ``convInit``, then
each level of ``down_layers`` (a stride-2 conv but at the first level, then its
``ResBlock``s), then each level of ``up_samples`` (a 1x1 conv halving the channels and a
nearest ×2 upsample, as the JAX net's, where torch MONAI's is linear) added to the
encoder's output of the same size, and its ``up_layers``; last ``norm_final``, the
activation and the 1x1 ``conv_final``. Every 3x3x3 stride-1 conv runs kernel 1
(``ops/conv3d.py``), the stride-2 and 1x1 convs cuDNN in full float32, the group norms
``nn.GroupNorm``. ``dropout_prob`` drops elements after ``convInit`` (``nn.Dropout``, as
``nnx.Dropout``), in train mode only.

Module names are torch MONAI's (``down_layers.1.0.conv.weight``, ``up_samples.0.0.conv``,
``down_layers.0.1.norm1.weight``) but for the head, which keeps the JAX net's
``norm_final`` and ``conv_final``. ``networks.weights.segresnet_state_dict_from_jax`` maps a
JAX net's parameters to these names. ``SegResNetVAE`` is not ported (ROADMAP A).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ...utils.backend import resolve_device
from ..blocks.segresnet_block import ResBlock, get_conv_layer
from ..blocks.upsample import UpSample
from ..layers.factories import Dropout, get_act_layer, get_norm_layer

__all__ = ["ResBlock", "SegResNet"]


class SegResNet(nn.Module):
    """``device=None`` is the CUDA card (``utils.backend.resolve_device``); pass
    ``device="cpu"`` for the CPU. The weights are drawn on the CPU from ``generator`` (or
    torch's global seed) and then moved, so one seed gives the same weights on either
    device."""

    def __init__(self, spatial_dims: int = 3, init_filters: int = 8, in_channels: int = 1, out_channels: int = 2,
                 dropout_prob: float | None = None, act=("RELU", {"inplace": True}),
                 norm=("GROUP", {"num_groups": 8}), use_conv_final: bool = True,
                 blocks_down: Sequence[int] = (1, 2, 2, 4), blocks_up: Sequence[int] = (1, 1, 1),
                 upsample_mode: str = "nontrainable", device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError("`spatial_dims` can only be 2 or 3.")
        self.spatial_dims = spatial_dims
        self.init_filters = init_filters
        self.in_channels = in_channels
        self.blocks_down = blocks_down
        self.blocks_up = blocks_up
        self.use_conv_final = use_conv_final
        device = resolve_device(device)
        made = dict(device="cpu", dtype=dtype, generator=generator)
        layer = dict(device="cpu", dtype=dtype)

        def block(channels: int) -> ResBlock:
            return ResBlock(spatial_dims, channels, norm=norm, act=act, **made)

        self.convInit = get_conv_layer(spatial_dims, in_channels, init_filters, **made)
        self.dropout = None if dropout_prob is None else Dropout[Dropout.DROPOUT, 1](dropout_prob)
        self.down_layers = nn.ModuleList()
        for i, n_blocks in enumerate(blocks_down):
            channels = init_filters * 2**i
            pre_conv = (get_conv_layer(spatial_dims, channels // 2, channels, stride=2, **made) if i > 0
                        else nn.Identity())
            self.down_layers.append(nn.Sequential(pre_conv, *[block(channels) for _ in range(n_blocks)]))
        n_up = len(blocks_up)
        self.up_layers, self.up_samples = nn.ModuleList(), nn.ModuleList()
        for i in range(n_up):
            sample_in = init_filters * 2 ** (n_up - i)
            self.up_layers.append(nn.Sequential(*[block(sample_in // 2) for _ in range(blocks_up[i])]))
            self.up_samples.append(nn.Sequential(
                get_conv_layer(spatial_dims, sample_in, sample_in // 2, kernel_size=1, **made),
                UpSample(spatial_dims, sample_in // 2, sample_in // 2, 2, mode=upsample_mode, pre_conv=None,
                         interp_mode="nearest")))
        if use_conv_final:
            self.norm_final = get_norm_layer(norm, spatial_dims, init_filters, **layer)
            self.act_final = get_act_layer(act)
            self.conv_final = get_conv_layer(spatial_dims, init_filters, out_channels, kernel_size=1, bias=True,
                                             **made)
        self.to(device)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        x = self.convInit(x)
        if self.dropout is not None:
            x = self.dropout(x)
        down_x = []
        for down in self.down_layers:
            x = down(x)
            down_x.append(x)
        return x, down_x

    def decode(self, x: torch.Tensor, down_x: list[torch.Tensor]) -> torch.Tensor:
        for i, (up, upl) in enumerate(zip(self.up_samples, self.up_layers)):
            x = upl(up(x) + down_x[i + 1])
        if self.use_conv_final:
            x = self.conv_final(self.act_final(self.norm_final(x)))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, down_x = self.encode(x)
        down_x.reverse()
        return self.decode(x, down_x)
