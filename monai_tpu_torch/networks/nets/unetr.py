"""UNETR: a ViT encoder and a conv decoder (counterpart of monai_tpu/networks/nets/unetr.py),
with torch MONAI's module names (``vit``, ``encoder1`` to ``encoder4``, ``decoder5`` to
``decoder2``, ``out``), so the ``state_dict`` keys are torch MONAI's;
``networks.weights.unetr_state_dict_from_jax`` maps a JAX net's parameters to them.

The ViT (``nets/vit.py``, patch 16, 12 layers) takes the channel-first image; the outputs
of its blocks 3, 6 and 9 and its normed output are laid out as (B, hidden, *img_size / 16)
maps (``proj_feat``) and projected up by ``UnetrPrUpBlock``s (``encoder2``: two more
transposed convs, ``encoder3`` one, ``encoder4`` none) to the skips of a ``UnetrUpBlock``
decoder, whose last skip is ``encoder1`` on the image itself. The conv blocks are
``UnetResBlock``s where ``res_block``: each 3x3x3 stride-1 conv runs kernel 1
(``ops/conv3d.py``) and each instance norm B2 (``instance_norm_prelu``, the LeakyReLU fused
into ``norm1``), forward and backward; the transposed and 1x1 convs run cuDNN in full
float32. The decoder's activations and the projected maps stay in channels-last memory,
so the moves between the token and channel layouts are views.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ...utils.backend import resolve_device
from ...utils.misc import ensure_tuple_rep
from ..blocks.dynunet_block import UnetOutBlock, UnetrBasicBlock, UnetrPrUpBlock, UnetrUpBlock
from ..layers.fast_norm import channels_last
from .vit import ViT

__all__ = ["UNETR"]


class UNETR(nn.Module):
    """``UNETR(1, 14, img_size=96, feature_size=16, hidden_size=768, mlp_dim=3072,
    num_heads=12, proj_type="perceptron", norm_name="instance", res_block=True)`` is the
    BTCV research recipe's network. Channel-first (B, C, *img_size) in and out; 2-D or 3-D.
    ``device=None`` is the CUDA card; the weights are drawn on the CPU from ``generator`` (or
    torch's global seed) and then moved, so one seed gives the same weights on either
    device."""

    def __init__(self, in_channels: int, out_channels: int, img_size: Sequence[int] | int, feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12, proj_type: str = "conv",
                 norm_name=("instance", {"affine": True}), conv_block: bool = True, res_block: bool = True,
                 dropout_rate: float = 0.0, spatial_dims: int = 3, qkv_bias: bool = False, save_attn: bool = False,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        if hidden_size % num_heads != 0:
            raise ValueError("hidden_size should be divisible by num_heads.")
        device = resolve_device(device)
        made = dict(device="cpu", dtype=dtype, generator=generator)
        self.num_layers = 12
        img_size = ensure_tuple_rep(img_size, spatial_dims)
        self.patch_size = ensure_tuple_rep(16, spatial_dims)
        self.feat_size = tuple(i // p for i, p in zip(img_size, self.patch_size))
        self.hidden_size = hidden_size
        self.in_channels = in_channels
        self.vit = ViT(in_channels, img_size, self.patch_size, hidden_size, mlp_dim, self.num_layers, num_heads,
                       proj_type, "learnable", False, dropout_rate=dropout_rate, spatial_dims=spatial_dims,
                       qkv_bias=qkv_bias, save_attn=save_attn, **made)
        f = feature_size
        pr = dict(norm_name=norm_name, conv_block=conv_block, res_block=res_block, **made)
        self.encoder1 = UnetrBasicBlock(spatial_dims, in_channels, f, 3, 1, norm_name, res_block, **made)
        self.encoder2 = UnetrPrUpBlock(spatial_dims, hidden_size, 2 * f, num_layer=2, **pr)
        self.encoder3 = UnetrPrUpBlock(spatial_dims, hidden_size, 4 * f, num_layer=1, **pr)
        self.encoder4 = UnetrPrUpBlock(spatial_dims, hidden_size, 8 * f, num_layer=0, **pr)
        self.decoder5 = UnetrUpBlock(spatial_dims, hidden_size, 8 * f, 3, 2, norm_name, res_block, **made)
        self.decoder4 = UnetrUpBlock(spatial_dims, 8 * f, 4 * f, 3, 2, norm_name, res_block, **made)
        self.decoder3 = UnetrUpBlock(spatial_dims, 4 * f, 2 * f, 3, 2, norm_name, res_block, **made)
        self.decoder2 = UnetrUpBlock(spatial_dims, 2 * f, f, 3, 2, norm_name, res_block, **made)
        self.out = UnetOutBlock(spatial_dims, f, out_channels, **made)
        self.to(device)

    def proj_feat(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens (B, N, hidden) as a channel-first (B, hidden, *feat_size) view of their
        channels-last memory."""
        return x.reshape(x.shape[0], *self.feat_size, self.hidden_size).movedim(-1, 1)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        x, hidden_states_out = self.vit(x_in)
        enc1 = self.encoder1(channels_last(x_in))
        enc2 = self.encoder2(self.proj_feat(hidden_states_out[3]))
        enc3 = self.encoder3(self.proj_feat(hidden_states_out[6]))
        enc4 = self.encoder4(self.proj_feat(hidden_states_out[9]))
        dec3 = self.decoder5(self.proj_feat(x), enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        return self.out(self.decoder2(dec1, enc1))
