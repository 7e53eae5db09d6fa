"""Transformer blocks that SwinUNETR uses (counterpart of
monai_tpu/networks/blocks/attention.py: ``MLPBlock`` and ``PatchEmbed``), with torch
MONAI's module names (``linear1``, ``linear2``; ``proj``, ``norm``). Both work on
channels-last tensors (B, *spatial, C), as the JAX package's do.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.misc import ensure_tuple_rep
from ..layers.factories import Conv, Norm, get_act_layer, linear

__all__ = ["MLPBlock", "PatchEmbed"]


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
