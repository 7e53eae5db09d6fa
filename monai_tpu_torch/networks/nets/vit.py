"""ViT and ViTAutoEnc (counterpart of monai_tpu/networks/nets/vit.py), with torch MONAI's
module names (``patch_embedding``, ``blocks.<i>``, ``norm``, ``cls_token``,
``classification_head``; ``conv3d_transpose``, ``conv3d_transpose_1``).

Both take a channel-first image (B, C, *spatial) and return the output with the list of
every transformer block's output (B, N, hidden). The blocks are
``blocks/attention.py``'s: attention by ``F.scaled_dot_product_attention``, the linear
layers plain torch in float32 (torch's default leaves TF32 off for them), LayerNorm eps
1e-6 and the tanh GELU, as the JAX package. ``ViTAutoEnc``'s decoder is the JAX
package's: a transposed conv of kernel = stride = ``patch_size`` to ``deconv_chns``, then
one of kernel 1 to ``out_channels`` (torch MONAI's are two of kernel = stride = 4), each
cuDNN in full float32.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ...utils.backend import resolve_device
from ...utils.misc import ensure_tuple_rep
from ..blocks.attention import PatchEmbeddingBlock, TransformerBlock
from ..layers.factories import Conv, Norm, linear

__all__ = ["ViT", "ViTAutoEnc"]


class ViT(nn.Module):
    """Vision transformer: ``patch_embedding``, ``num_layers`` ``TransformerBlock``s,
    ``norm``. With ``classification``, a learned ``cls_token`` (zeros at init) leads the
    tokens and the output is ``classification_head`` of its final state,
    ``Sequential(Linear, Tanh)`` as in torch MONAI where ``post_activation`` is ``"Tanh"``
    and ``Sequential(Linear, Identity)`` otherwise; without it, the normed tokens.
    ``device=None`` is the CUDA card; the weights are drawn on the CPU from ``generator``
    and then moved."""

    def __init__(self, in_channels: int, img_size: Sequence[int] | int, patch_size: Sequence[int] | int,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_layers: int = 12, num_heads: int = 12,
                 proj_type: str = "conv", pos_embed_type: str = "learnable", classification: bool = False,
                 num_classes: int = 2, dropout_rate: float = 0.0, spatial_dims: int = 3,
                 post_activation: str = "Tanh", qkv_bias: bool = False, save_attn: bool = False, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        made = dict(device="cpu", dtype=dtype, generator=generator)
        self.classification = classification
        self.patch_embedding = PatchEmbeddingBlock(in_channels, img_size, patch_size, hidden_size, num_heads,
                                                   proj_type, pos_embed_type, dropout_rate, spatial_dims, **made)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, mlp_dim, num_heads, dropout_rate, qkv_bias, save_attn, **made)
            for _ in range(num_layers))
        self.norm = Norm[Norm.LAYER, 1](hidden_size, device="cpu", dtype=dtype)
        if classification:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size, dtype=dtype))
            self.classification_head = nn.Sequential(linear(hidden_size, num_classes, **made),
                                                     nn.Tanh() if post_activation == "Tanh" else nn.Identity())
        self.to(device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        x = self.patch_embedding(x)
        if self.classification:
            x = torch.cat((self.cls_token.expand(x.shape[0], -1, -1), x), dim=1)
        hidden_states_out = []
        for blk in self.blocks:
            x = blk(x)
            hidden_states_out.append(x)
        x = self.norm(x)
        if self.classification:
            return self.classification_head(x[:, 0]), hidden_states_out
        return x, hidden_states_out


class ViTAutoEnc(nn.Module):
    """ViT encoder and a transposed-conv decoder back to the input's size, for
    self-supervised pretraining: the normed tokens as a (B, hidden, *grid) map, then
    ``conv3d_transpose`` (kernel = stride = ``patch_size``) and ``conv3d_transpose_1``
    (kernel 1). ``device=None`` is the CUDA card."""

    def __init__(self, in_channels: int, img_size: Sequence[int] | int, patch_size: Sequence[int] | int,
                 out_channels: int = 1, deconv_chns: int = 16, hidden_size: int = 768, mlp_dim: int = 3072,
                 num_layers: int = 12, num_heads: int = 12, proj_type: str = "conv", dropout_rate: float = 0.0,
                 spatial_dims: int = 3, qkv_bias: bool = False, save_attn: bool = False, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        made = dict(device="cpu", dtype=dtype, generator=generator)
        self.spatial_dims = spatial_dims
        self.patch_size = ensure_tuple_rep(patch_size, spatial_dims)
        self.patch_embedding = PatchEmbeddingBlock(in_channels, img_size, self.patch_size, hidden_size, num_heads,
                                                   proj_type, "learnable", dropout_rate, spatial_dims, **made)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, mlp_dim, num_heads, dropout_rate, qkv_bias, save_attn, **made)
            for _ in range(num_layers))
        self.norm = Norm[Norm.LAYER, 1](hidden_size, device="cpu", dtype=dtype)
        self.conv3d_transpose = Conv[Conv.CONVTRANS, spatial_dims](hidden_size, deconv_chns, kernel_size=self.patch_size,
                                                                   stride=self.patch_size, **made)
        self.conv3d_transpose_1 = Conv[Conv.CONVTRANS, spatial_dims](deconv_chns, out_channels, kernel_size=1, **made)
        self.to(device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        grid = tuple(s // p for s, p in zip(x.shape[2:], self.patch_size))
        x = self.patch_embedding(x)
        hidden_states_out = []
        for blk in self.blocks:
            x = blk(x)
            hidden_states_out.append(x)
        x = self.norm(x)
        x = x.reshape(x.shape[0], *grid, x.shape[-1]).movedim(-1, 1)
        return self.conv3d_transpose_1(self.conv3d_transpose(x)), hidden_states_out
