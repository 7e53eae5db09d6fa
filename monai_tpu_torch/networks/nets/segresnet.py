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
JAX net's parameters to these names.

``SegResNetVAE`` adds the JAX net's VAE branch, whose layers and names are the JAX net's
(torch MONAI's ``vae_down`` and ``vae_fc_up_sample`` hold a bias, a second activation and a
norm more): ``vae_down_norm``, the activation, the stride-2 ``vae_down_conv`` and
``vae_down_norm2`` on the encoder's output; ``vae_fc1`` (the mean), ``vae_fc2`` (the
log-std's input where ``vae_estimate_std``), a draw of N(0, 1) noise, ``vae_fc3`` and a ReLU;
``vae_fc_up_sample`` (a 1x1 conv and the upsample), the decoder's own ``up_samples`` and
``up_layers``, and ``vae_conv_final`` back to the input's channels. It returns the logits
and the VAE loss, the KL-style regulariser plus the mean squared error of the rebuilt
input.
"""
from __future__ import annotations

from collections.abc import Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.backend import resolve_device
from ..blocks.segresnet_block import ResBlock, get_conv_layer
from ..blocks.upsample import UpSample
from ..layers.factories import Dropout, get_act_layer, get_norm_layer, linear
from ..utils import generator_on

__all__ = ["ResBlock", "SegResNet", "SegResNetVAE"]


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
                         interp_mode="nearest", **made)))
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


class SegResNetVAE(SegResNet):
    """SegResNet with the VAE branch of the JAX net (see the module docstring): ``forward``
    returns (logits, VAE loss). ``input_image_size`` is the spatial size the net is trained
    at, each a multiple of 2 ** len(blocks_down). The noise comes from ``sample_noise``, one
    N(0, 1) draw of the mean's shape on the mean's device from ``noise_generator`` (torch's
    default generator where None) through ``generator_on``: a test can replace the method to
    feed a given draw. ``device=None`` is the CUDA card."""

    def __init__(self, input_image_size: Sequence[int], vae_estimate_std: bool = False, vae_default_std: float = 0.3,
                 vae_nz: int = 256, spatial_dims: int = 3, init_filters: int = 8, in_channels: int = 1,
                 out_channels: int = 2, dropout_prob: float | None = None, act=("RELU", {"inplace": True}),
                 norm=("GROUP", {"num_groups": 8}), use_conv_final: bool = True,
                 blocks_down: Sequence[int] = (1, 2, 2, 4), blocks_up: Sequence[int] = (1, 1, 1),
                 upsample_mode: str = "nontrainable", device=None, dtype=None,
                 generator: torch.Generator | None = None, noise_generator: torch.Generator | None = None):
        device = resolve_device(device)
        super().__init__(spatial_dims=spatial_dims, init_filters=init_filters, in_channels=in_channels,
                         out_channels=out_channels, dropout_prob=dropout_prob, act=act, norm=norm,
                         use_conv_final=use_conv_final, blocks_down=blocks_down, blocks_up=blocks_up,
                         upsample_mode=upsample_mode, device="cpu", dtype=dtype, generator=generator)
        made = dict(device="cpu", dtype=dtype, generator=generator)
        layer = dict(device="cpu", dtype=dtype)
        self.input_image_size = tuple(input_image_size)
        self.smallest_filters = 16
        zoom = 2 ** (len(blocks_down) - 1)
        self.fc_insize = tuple(s // (2 * zoom) for s in self.input_image_size)
        self.vae_estimate_std = vae_estimate_std
        self.vae_default_std = vae_default_std
        self.vae_nz = vae_nz
        self.noise_generator = noise_generator
        self._generators: dict = {}
        v_filters = init_filters * zoom
        total = self.smallest_filters * math.prod(self.fc_insize)
        self.vae_down_norm = get_norm_layer(norm, spatial_dims, v_filters, **layer)
        self.vae_down_act = get_act_layer(act)
        self.vae_down_conv = get_conv_layer(spatial_dims, v_filters, self.smallest_filters, stride=2, **made)
        self.vae_down_norm2 = get_norm_layer(norm, spatial_dims, self.smallest_filters, **layer)
        self.vae_fc1 = linear(total, vae_nz, **made)
        self.vae_fc2 = linear(total, vae_nz, **made)
        self.vae_fc3 = linear(vae_nz, total, **made)
        self.vae_fc_up_sample = nn.Sequential(
            get_conv_layer(spatial_dims, self.smallest_filters, v_filters, kernel_size=1, **made),
            UpSample(spatial_dims, v_filters, v_filters, 2, mode=upsample_mode, pre_conv=None, interp_mode="nearest",
                     **made))
        self.vae_conv_final = get_conv_layer(spatial_dims, init_filters, in_channels, kernel_size=1, bias=True, **made)
        self.to(device)

    def sample_noise(self, like: torch.Tensor) -> torch.Tensor:
        """One N(0, 1) draw of ``like``'s shape and type on its device."""
        g = generator_on(self.noise_generator, like.device, self._generators)
        return torch.randn(like.shape, generator=g, device=like.device, dtype=like.dtype)

    def _get_vae_loss(self, net_input: torch.Tensor, vae_input: torch.Tensor) -> torch.Tensor:
        x_vae = self.vae_down_norm2(self.vae_down_conv(self.vae_down_act(self.vae_down_norm(vae_input))))
        x_flat = x_vae.movedim(1, -1).flatten(1)  # flattened in the JAX net's (*S, C) order
        z_mean = self.vae_fc1(x_flat)
        z_mean_rand = self.sample_noise(z_mean).detach()
        if self.vae_estimate_std:
            z_sigma = F.softplus(self.vae_fc2(x_flat))
            vae_reg_loss = 0.5 * torch.mean(z_mean**2 + z_sigma**2 - torch.log(1e-8 + z_sigma**2) - 1)
        else:
            z_sigma = self.vae_default_std
            vae_reg_loss = torch.mean(z_mean**2)
        x_vae = F.relu(self.vae_fc3(z_mean + z_sigma * z_mean_rand))
        x_vae = x_vae.reshape(x_vae.shape[0], *self.fc_insize, self.smallest_filters).movedim(-1, 1)
        x_vae = self.vae_fc_up_sample(x_vae)
        for up, upl in zip(self.up_samples, self.up_layers):
            x_vae = upl(up(x_vae))
        x_vae = self.vae_conv_final(x_vae)
        return vae_reg_loss + torch.mean((net_input - x_vae) ** 2)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        net_input = x
        x, down_x = self.encode(x)
        down_x.reverse()
        vae_input = x
        x = self.decode(x, down_x)
        return x, self._get_vae_loss(net_input, vae_input)
