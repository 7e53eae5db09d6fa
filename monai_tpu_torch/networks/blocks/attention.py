"""Transformer blocks (counterpart of monai_tpu/networks/blocks/attention.py): ``MLPBlock``
and ``PatchEmbed``, which SwinUNETR uses, and ``SABlock``, ``CrossAttentionBlock``,
``TransformerBlock`` and ``PatchEmbeddingBlock``, which the ViT and UNETR use, with torch
MONAI's module names (``linear1``, ``linear2``; ``proj``, ``norm``; ``qkv``, ``out_proj``;
``to_q``, ``to_k``, ``to_v``; ``norm1``, ``attn``, ``norm2``, ``mlp``, ``norm_cross``,
``cross_attn``; ``patch_embeddings``, ``position_embeddings``). ``MLPBlock``,
``PatchEmbed`` and the attention blocks work on channels-last tensors (B, *spatial, C) or
token sequences (B, N, C); ``PatchEmbeddingBlock`` takes a channel-first image.

Attention is ``F.scaled_dot_product_attention`` at scale 1/sqrt(head dim), as the JAX
package's ``jax.nn.dot_product_attention``: the JAX package computes it outside any
Pallas kernel, so the port has no kernel of its own for it. One call does the products,
the softmax and (in training) keeps the (B, heads, N, N) scores out of memory for the
backward, on whichever of PyTorch's attention backends takes the input; ``chip_smoke.py``
holds the ViT's float32 forward and step on the card to the CPU's. Where the JAX package
differs from torch MONAI, the port
follows it: LayerNorm eps 1e-6 (torch MONAI 1e-5), GELU in the tanh approximation (torch
MONAI the exact erf), and ``SABlock`` and ``CrossAttentionBlock`` drop only after
``out_proj`` (torch MONAI also drops the attention weights); ``save_attn`` is taken and
keeps nothing.
"""
from __future__ import annotations

from collections.abc import Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.misc import ensure_tuple_rep
from ..layers.factories import Conv, Norm, get_act_layer, linear

__all__ = ["CrossAttentionBlock", "MLPBlock", "PatchEmbed", "PatchEmbeddingBlock", "SABlock", "TransformerBlock"]


class MLPBlock(nn.Module):
    """linear1 → activation (GELU, tanh approximation) → dropout → linear2 → dropout."""

    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float = 0.0, act="GELU", device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        mlp_dim = mlp_dim or hidden_size * 4
        self.linear1 = linear(hidden_size, mlp_dim, device=device, dtype=dtype, generator=generator)
        self.linear2 = linear(mlp_dim, hidden_size, device=device, dtype=dtype, generator=generator)
        self.fn = get_act_layer(act)
        self.drop1 = nn.Dropout(dropout_rate)
        self.drop2 = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.linear2(self.drop1(self.fn(self.linear1(x)))))


class PatchEmbed(nn.Module):
    """Non-overlapping patches to ``embed_dim`` channels by a conv with kernel = stride =
    ``patch_size``, keeping the spatial layout; spatial sizes that are not a multiple of
    the patch are zero-padded at the end. Channels-last in and out."""

    def __init__(self, patch_size: Sequence[int] | int = 2, in_chans: int = 1, embed_dim: int = 48,
                 norm_layer: bool = False, spatial_dims: int = 3, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size = ensure_tuple_rep(patch_size, spatial_dims)
        self.proj = Conv[Conv.CONV, spatial_dims](in_chans, embed_dim, kernel_size=self.patch_size,
                                                  stride=self.patch_size, device=device, dtype=dtype,
                                                  generator=generator)
        self.norm = Norm[Norm.LAYER, spatial_dims](embed_dim, device=device, dtype=dtype) if norm_layer else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = []
        for s, p in zip(reversed(x.shape[1:-1]), reversed(self.patch_size)):  # F.pad lists the last dim first
            pad += [0, (p - s % p) % p]
        if any(pad):
            x = F.pad(x, [0, 0, *pad])
        x = self.proj(x.movedim(-1, 1)).movedim(1, -1)
        return x if self.norm is None else self.norm(x)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, heads * d) to (B, heads, N, d)."""
    b, n, _ = x.shape
    return x.reshape(b, n, heads, -1).transpose(1, 2)


class SABlock(nn.Module):
    """Multi-head self-attention on (B, N, ``hidden_size``): ``qkv`` (bias where
    ``qkv_bias``), its output split as (B, N, 3, heads, head dim), attention (causal where
    ``causal``), ``out_proj``, dropout."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0, qkv_bias: bool = False,
                 save_attn: bool = False, dim_head: int | None = None, causal: bool = False, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        if hidden_size % num_heads != 0:
            raise ValueError("hidden size should be divisible by num_heads.")
        self.num_heads = num_heads
        self.dim_head = hidden_size // num_heads if dim_head is None else dim_head
        inner = self.dim_head * num_heads
        made = dict(device=device, dtype=dtype, generator=generator)
        self.qkv = linear(hidden_size, inner * 3, bias=qkv_bias, **made)
        self.out_proj = linear(inner, hidden_size, **made)
        self.drop_output = nn.Dropout(dropout_rate)
        self.causal = causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, self.dim_head).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=self.causal)
        return self.drop_output(self.out_proj(out.transpose(1, 2).reshape(b, n, -1)))


class CrossAttentionBlock(nn.Module):
    """Multi-head attention of (B, N, ``hidden_size``) queries over a context (B, M,
    ``context_input_size``), the input itself where none is given: ``to_q``, ``to_k``,
    ``to_v``, attention (causal where ``causal``), ``out_proj``, dropout."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0, qkv_bias: bool = False,
                 context_input_size: int | None = None, dim_head: int | None = None, causal: bool = False,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        if hidden_size % num_heads != 0:
            raise ValueError("hidden size should be divisible by num_heads.")
        self.num_heads = num_heads
        self.dim_head = hidden_size // num_heads if dim_head is None else dim_head
        inner = self.dim_head * num_heads
        context_input_size = context_input_size or hidden_size
        made = dict(device=device, dtype=dtype, generator=generator)
        self.to_q = linear(hidden_size, inner, bias=qkv_bias, **made)
        self.to_k = linear(context_input_size, inner, bias=qkv_bias, **made)
        self.to_v = linear(context_input_size, inner, bias=qkv_bias, **made)
        self.out_proj = linear(inner, hidden_size, **made)
        self.drop_output = nn.Dropout(dropout_rate)
        self.causal = causal

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        context = x if context is None else context
        q, k, v = (_heads(f(t), self.num_heads) for f, t in ((self.to_q, x), (self.to_k, context), (self.to_v, context)))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=self.causal)
        return self.drop_output(self.out_proj(out.transpose(1, 2).reshape(b, n, -1)))


class TransformerBlock(nn.Module):
    """Pre-norm transformer block: x + attn(norm1(x)), then (``with_cross_attention``)
    x + cross_attn(norm_cross(x), context), then x + mlp(norm2(x))."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int, dropout_rate: float = 0.0,
                 qkv_bias: bool = False, save_attn: bool = False, causal: bool = False,
                 with_cross_attention: bool = False, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        made = dict(device=device, dtype=dtype, generator=generator)
        self.norm1 = Norm[Norm.LAYER, 1](hidden_size, device=device, dtype=dtype)
        self.attn = SABlock(hidden_size, num_heads, dropout_rate, qkv_bias, save_attn, causal=causal, **made)
        self.norm2 = Norm[Norm.LAYER, 1](hidden_size, device=device, dtype=dtype)
        self.mlp = MLPBlock(hidden_size, mlp_dim, dropout_rate, **made)
        self.with_cross_attention = with_cross_attention
        if with_cross_attention:
            self.norm_cross = Norm[Norm.LAYER, 1](hidden_size, device=device, dtype=dtype)
            self.cross_attn = CrossAttentionBlock(hidden_size, num_heads, dropout_rate, qkv_bias, **made)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        if self.with_cross_attention:
            x = x + self.cross_attn(self.norm_cross(x), context=context)
        return x + self.mlp(self.norm2(x))


class _Patches(nn.Module):
    """A channel-first image (B, C, *(g p)) as its patches (B, prod g, prod p * C), each
    flattened in (p_1, ..., p_d, c) order (torch MONAI's ``Rearrange``)."""

    def __init__(self, patch_size: tuple[int, ...]):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, *spatial = x.shape
        d = len(spatial)
        grid = [s // p for s, p in zip(spatial, self.patch_size)]
        x = x.reshape(b, c, *(n for g, p in zip(grid, self.patch_size) for n in (g, p)))
        x = x.permute(0, *(2 + 2 * i for i in range(d)), *(3 + 2 * i for i in range(d)), 1)
        return x.reshape(b, math.prod(grid), -1)


class PatchEmbeddingBlock(nn.Module):
    """A channel-first image (B, C, *spatial) to patch tokens (B, N, ``hidden_size``), N the
    patches in row-major order: ``proj_type="conv"`` a conv of kernel = stride = patch
    (``patch_embeddings``), ``"perceptron"`` each patch flattened in (p_1, ..., p_d, c) order
    and a linear layer (``patch_embeddings.1``, after torch MONAI's ``Rearrange`` at 0); then
    the learned ``position_embeddings`` (1, N, ``hidden_size``, drawn as the JAX package draws
    them: a normal truncated at ±2, times 0.02) added, and dropout. ``pos_embed_type`` is
    taken and the embedding is learned whatever it says, as in the JAX package."""

    def __init__(self, in_channels: int, img_size: Sequence[int] | int, patch_size: Sequence[int] | int,
                 hidden_size: int, num_heads: int = 12, proj_type: str = "conv", pos_embed_type: str = "learnable",
                 dropout_rate: float = 0.0, spatial_dims: int = 3, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError(f"dropout_rate {dropout_rate} should be between 0 and 1.")
        if hidden_size % num_heads != 0:
            raise ValueError(f"hidden size {hidden_size} should be divisible by num_heads {num_heads}.")
        if proj_type not in ("conv", "perceptron"):
            raise KeyError(f"proj_type {proj_type} is not supported.")
        img_size = ensure_tuple_rep(img_size, spatial_dims)
        self.patch_size = ensure_tuple_rep(patch_size, spatial_dims)
        if any(m < p for m, p in zip(img_size, self.patch_size)):
            raise ValueError("patch_size should be smaller than img_size.")
        self.n_patches = math.prod(m // p for m, p in zip(img_size, self.patch_size))
        self.proj_type = proj_type
        made = dict(device=device, dtype=dtype, generator=generator)
        if proj_type == "conv":
            self.patch_embeddings = Conv[Conv.CONV, spatial_dims](in_channels, hidden_size, kernel_size=self.patch_size,
                                                                  stride=self.patch_size, **made)
        else:
            self.patch_embeddings = nn.Sequential(
                _Patches(self.patch_size), linear(in_channels * math.prod(self.patch_size), hidden_size, **made))
        table = torch.empty((1, self.n_patches, hidden_size), device=None if generator is None else generator.device)
        nn.init.trunc_normal_(table, std=1.0, a=-2.0, b=2.0, generator=generator)
        self.position_embeddings = nn.Parameter((table * 0.02).to(device=device, dtype=dtype))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embeddings(x)
        if self.proj_type == "conv":
            x = x.flatten(2).transpose(1, 2)
        return self.dropout(x + self.position_embeddings)
