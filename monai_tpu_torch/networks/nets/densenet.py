"""DenseNet-121/169/201/264 (counterpart of monai_tpu/networks/nets/densenet.py).

``features``: a 7x7 stride-2 conv, batch norm, ReLU and a 3x3 stride-2 max pool; then dense
blocks, each layer a batch norm, ReLU, 1x1 conv to ``bn_size * growth_rate`` channels,
batch norm, ReLU and 3x3 conv to ``growth_rate``, concatenated to its input; between the
blocks a transition (batch norm, ReLU, 1x1 conv halving the channels, 2x2 average pool),
after the last ``norm5``. ``class_layers``: ReLU, global average pool and a linear layer.
1-, 2- or 3-D. The convs are cuDNN's, in full float32 on float32 CUDA inputs, but for the
3-D net's dense-layer 3x3x3 convs, which run kernel 1 (``Conv3d``); the JAX package has no
2-D Pallas conv. The pools, the concatenations and the batch norms are torch's; the batch
norms add the biased batch variance to ``running_var``, as ``nnx.BatchNorm``.

Module names are torch MONAI's: ``features.conv0``, ``features.denseblock1.denselayer1.layers.conv1``,
``features.transition1.conv``, ``features.norm5``, ``class_layers.out``.
``networks.weights.densenet_state_dict_from_jax`` maps a JAX net's variables to them.
"""
from __future__ import annotations

from collections import OrderedDict
from collections.abc import Sequence

import torch
from torch import nn

from ...utils.backend import resolve_device
from ..layers.factories import Conv, Dropout, Pool, get_act_layer, get_norm_layer, linear

__all__ = ["DenseNet", "DenseNet121", "DenseNet169", "DenseNet201", "DenseNet264", "densenet121", "densenet169",
           "densenet201", "densenet264"]


class _DenseLayer(nn.Module):
    def __init__(self, spatial_dims: int, in_channels: int, growth_rate: int, bn_size: int, dropout_prob: float,
                 act, norm, made: dict, layer: dict):
        super().__init__()
        mid = bn_size * growth_rate
        conv = Conv[Conv.CONV, spatial_dims]
        self.layers = nn.Sequential(OrderedDict([
            ("norm1", get_norm_layer(norm, spatial_dims, in_channels, **layer)),
            ("relu1", get_act_layer(act)),
            ("conv1", conv(in_channels, mid, kernel_size=1, bias=False, **made)),
            ("norm2", get_norm_layer(norm, spatial_dims, mid, **layer)),
            ("relu2", get_act_layer(act)),
            ("conv2", conv(mid, growth_rate, kernel_size=3, padding=1, bias=False, **made)),
        ]))
        if dropout_prob > 0:
            self.layers.add_module("dropout", Dropout[Dropout.DROPOUT, 1](dropout_prob))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.layers(x)], dim=1)


class _DenseBlock(nn.Sequential):
    def __init__(self, spatial_dims: int, layers: int, in_channels: int, bn_size: int, growth_rate: int,
                 dropout_prob: float, act, norm, made: dict, layer: dict):
        super().__init__()
        for i in range(layers):
            self.add_module(f"denselayer{i + 1}", _DenseLayer(spatial_dims, in_channels, growth_rate, bn_size,
                                                              dropout_prob, act, norm, made, layer))
            in_channels += growth_rate


class _Transition(nn.Sequential):
    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, act, norm, made: dict, layer: dict):
        super().__init__()
        self.add_module("norm", get_norm_layer(norm, spatial_dims, in_channels, **layer))
        self.add_module("relu", get_act_layer(act))
        self.add_module("conv", Conv[Conv.CONV, spatial_dims](in_channels, out_channels, kernel_size=1, bias=False,
                                                             **made))
        self.add_module("pool", Pool["avg", spatial_dims](kernel_size=2, stride=2))


class DenseNet(nn.Module):
    """The DenseNet backbone and its classifier on channel-first (B, C, *spatial) inputs.
    ``device=None`` is the CUDA card (``utils.backend.resolve_device``); pass
    ``device="cpu"`` for the CPU. The weights are drawn on the CPU from ``generator`` (or
    torch's global seed) and then moved, so one seed gives the same weights on either
    device."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, init_features: int = 64,
                 growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16), bn_size: int = 4,
                 act=("relu", {"inplace": True}), norm="batch", dropout_prob: float = 0.0, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        device = resolve_device(device)
        made = dict(device="cpu", dtype=dtype, generator=generator)
        layer = dict(device="cpu", dtype=dtype)
        self.features = nn.Sequential(OrderedDict([
            ("conv0", Conv[Conv.CONV, spatial_dims](in_channels, init_features, kernel_size=7, stride=2, padding=3,
                                                    bias=False, **made)),
            ("norm0", get_norm_layer(norm, spatial_dims, init_features, **layer)),
            ("relu0", get_act_layer(act)),
            ("pool0", Pool["max", spatial_dims](kernel_size=3, stride=2, padding=1)),
        ]))
        channels = init_features
        for i, num_layers in enumerate(block_config):
            self.features.add_module(f"denseblock{i + 1}", _DenseBlock(spatial_dims, num_layers, channels, bn_size,
                                                                       growth_rate, dropout_prob, act, norm, made,
                                                                       layer))
            channels += num_layers * growth_rate
            if i == len(block_config) - 1:
                self.features.add_module("norm5", get_norm_layer(norm, spatial_dims, channels, **layer))
            else:
                self.features.add_module(f"transition{i + 1}", _Transition(spatial_dims, channels, channels // 2,
                                                                           act, norm, made, layer))
                channels //= 2
        self.class_layers = nn.Sequential(OrderedDict([
            ("relu", get_act_layer(act)),
            ("pool", Pool["adaptiveavg", spatial_dims](1)),
            ("flatten", nn.Flatten(1)),
            ("out", linear(channels, out_channels, **made)),
        ]))
        self.to(device)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """The headless feature map, after the classifier's ReLU (channel-first)."""
        return self.class_layers.relu(self.features(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.class_layers(self.features(x))


def DenseNet121(spatial_dims: int, in_channels: int, out_channels: int, **kwargs) -> DenseNet:
    return DenseNet(spatial_dims, in_channels, out_channels, init_features=64, growth_rate=32,
                    block_config=(6, 12, 24, 16), **kwargs)


def DenseNet169(spatial_dims: int, in_channels: int, out_channels: int, **kwargs) -> DenseNet:
    return DenseNet(spatial_dims, in_channels, out_channels, init_features=64, growth_rate=32,
                    block_config=(6, 12, 32, 32), **kwargs)


def DenseNet201(spatial_dims: int, in_channels: int, out_channels: int, **kwargs) -> DenseNet:
    return DenseNet(spatial_dims, in_channels, out_channels, init_features=64, growth_rate=32,
                    block_config=(6, 12, 48, 32), **kwargs)


def DenseNet264(spatial_dims: int, in_channels: int, out_channels: int, **kwargs) -> DenseNet:
    return DenseNet(spatial_dims, in_channels, out_channels, init_features=64, growth_rate=32,
                    block_config=(6, 12, 64, 48), **kwargs)


densenet121, densenet169, densenet201, densenet264 = DenseNet121, DenseNet169, DenseNet201, DenseNet264
