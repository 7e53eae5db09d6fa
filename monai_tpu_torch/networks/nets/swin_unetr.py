"""SwinUNETR: a Swin-transformer encoder and a UNETR-style conv decoder (counterpart of
monai_tpu/networks/nets/swin_unetr.py).

The public API takes and returns channel-first (B, C, *spatial) tensors. The Swin
encoder works channels-last (B, *spatial, C), as the JAX package's does; the input and
the decoder's activations are kept in channels-last memory, so the moves between the
two layouts are views. Module names follow torch MONAI (``swinViT.layers1.0.blocks.0
.attn.qkv``, ``encoder1.layer.conv1.conv``, ``decoder5.transp_conv.conv``,
``out.conv.conv``), so the ``state_dict`` keys are torch MONAI's.

Window attention runs the CUDA kernel of ``ops/window_attention.py``, forward and (under
autograd) backward; the 3x3x3 convs and the instance norms run the UNet path's kernels,
forward and backward. The relative-position bias gets its grad through the table gather
by autograd. The shifted-window masks are built on the device by torch ops, once per
padded size, window and shift, and kept there; a traced forward (``torch.export``) builds
them in its graph each call instead, so that an exported program carries no mask (BTCV's
first stage's is 161 MB) as a constant to copy to the card at every call.

Where the JAX package differs from torch MONAI, the port follows the JAX package:
LayerNorm eps 1e-6 (torch MONAI 1e-5) and GELU in the tanh approximation (torch MONAI
the exact erf), so a torch MONAI checkpoint gives slightly different logits; and
``use_checkpoint`` and ``dropout_path_rate`` are taken and have no effect, as in the JAX
package (torch MONAI recomputes each stage under ``use_checkpoint``, which bounds its
memory, and drops paths at ``dropout_path_rate``). Not taken: ``use_v2`` and the
deprecated ``img_size``. Attention dropout (``attn_drop_rate`` > 0) is the JAX package's
route off its kernel: in train mode the attention is products, softmax and dropout in
plain torch (``WindowAttention``), the dropout drawn from the module's generator; in eval
mode, where the dropout is the identity, it is the kernel as at rate 0.
"""
from __future__ import annotations

import itertools
import math
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.window_attention import fused_window_attention
from ...utils.backend import resolve_device
from ...utils.misc import ensure_tuple_rep
from ..blocks.attention import MLPBlock, PatchEmbed
from ..blocks.dynunet_block import UnetOutBlock, UnetrBasicBlock, UnetrUpBlock
from ..layers.factories import Norm, linear
from ..layers.fast_norm import channels_last
from ..utils import generator_on

__all__ = ["SwinUNETR", "SwinTransformer", "WindowAttention", "SwinTransformerBlock", "PatchMerging",
           "PatchMergingV2", "MERGING_MODE", "BasicLayer", "window_partition", "window_reverse",
           "get_window_size", "compute_mask", "filter_swinunetr"]


def window_partition(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """(B, *spatial, C) → (B·nW, prod(window_size), C); the windows of one image in
    row-major order of the window grid, so window i of the batch is grid cell i % nW."""
    b, *sp, c = x.shape
    nd = len(sp)
    shape = [b]
    for s, w in zip(sp, window_size):
        shape += [s // w, w]
    perm = (0, *range(1, 2 * nd, 2), *range(2, 2 * nd + 1, 2), 2 * nd + 1)
    return x.reshape(*shape, c).permute(perm).reshape(-1, math.prod(window_size), c)


def window_reverse(windows: torch.Tensor, window_size: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    """Inverse of ``window_partition``; ``dims`` is (B, *spatial)."""
    b, *sp = dims
    nd = len(sp)
    grid = [s // w for s, w in zip(sp, window_size)]
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    x = windows.reshape(b, *grid, *window_size, -1).permute(*perm, 1 + 2 * nd)
    return x.reshape(b, *sp, -1)


def get_window_size(x_size: Sequence[int], window_size: Sequence[int], shift_size: Sequence[int] | None = None):
    """Clamp the window (and zero the shift) along each dim no larger than the window."""
    use_window_size = list(window_size)
    use_shift_size = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            if use_shift_size is not None:
                use_shift_size[i] = 0
    if shift_size is None:
        return tuple(use_window_size)
    return tuple(use_window_size), tuple(use_shift_size)


def compute_mask(dims: Sequence[int], window_size: Sequence[int], shift_size: Sequence[int],
                 device=None) -> torch.Tensor:
    """Additive float32 attention mask (nW, N, N) of the shifted windows over a padded grid
    of ``dims``, on ``device`` (default the CPU): 0 between tokens of one region of the
    cyclically shifted image, -100 between tokens of different regions."""
    img_mask = torch.zeros(tuple(dims), device=device)
    regions = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window_size, shift_size)]
    for cnt, region in enumerate(itertools.product(*regions)):
        img_mask[region] = cnt
    nd = len(dims)
    shape = []
    for s, w in zip(dims, window_size):
        shape += [s // w, w]
    perm = (*range(0, 2 * nd, 2), *range(1, 2 * nd, 2))
    mask_windows = img_mask.reshape(shape).permute(perm).reshape(-1, math.prod(window_size))
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return torch.where(attn_mask != 0, -100.0, 0.0)


def _rel_pos_index(window_size: Sequence[int]) -> np.ndarray:
    """(N, N) index into the relative position bias table."""
    coords = np.stack(np.meshgrid(*[np.arange(ws) for ws in window_size], indexing="ij"))
    coords_flat = coords.reshape(len(window_size), -1)
    relative = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)
    for i, ws in enumerate(window_size):
        relative[:, :, i] += ws - 1
    mul = 1
    idx = np.zeros(relative.shape[:2], dtype=np.int64)
    for i in reversed(range(len(window_size))):
        idx += relative[:, :, i] * mul
        mul *= 2 * window_size[i] - 1
    return idx


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window, with a learned relative position
    bias; (B·nW, N, C) in and out. The fused kernel computes it, but in train mode at an
    ``attn_drop`` above 0: then it is q kᵀ + bias + mask, softmax, dropout and the product
    with v in plain torch (``_attention_with_dropout``), as the JAX package leaves its
    kernel for einsum, softmax, dropout and einsum. The dropout keeps each weight where a
    uniform draw on the weights' device is at least ``attn_drop``, and scales it by
    1 / (1 - ``attn_drop``); the draw comes from ``dropout_generator`` (the construction's
    generator; torch's default one where None) through ``generator_on``."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int], qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0.0 <= attn_drop < 1.0:
            raise ValueError(f"attn_drop {attn_drop} should be in [0, 1)")
        self.attn_drop = attn_drop
        self.dropout_generator = generator
        self._generators: dict = {}
        self.dim = dim
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        n_bias = math.prod(2 * ws - 1 for ws in self.window_size)
        table = torch.empty((n_bias, num_heads), device=None if generator is None else generator.device)
        nn.init.trunc_normal_(table, std=1.0, a=-2.0, b=2.0, generator=generator)
        self.relative_position_bias_table = nn.Parameter((table * 0.02).to(device=device, dtype=dtype))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_pos_index(self.window_size)).to(device))
        self.qkv = linear(dim, dim * 3, bias=qkv_bias, device=device, dtype=dtype, generator=generator)
        self.proj = linear(dim, dim, device=device, dtype=dtype, generator=generator)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4).contiguous()
        q = qkv[0] * self.scale  # (b, heads, n, d)
        # the index sliced to the token count: windows clamp on small inputs, and the
        # 7^3 table's first n x n entries serve a smaller window, as in torch MONAI
        idx = self.relative_position_index[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1).float().contiguous()
        if self.training and self.attn_drop > 0:
            out = self._attention_with_dropout(q, qkv[1], qkv[2], bias, mask)
        else:
            out = fused_window_attention(q, qkv[1], qkv[2], bias, mask)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(b, n, c)))

    def _attention_with_dropout(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                                mask: torch.Tensor | None) -> torch.Tensor:
        b, h, n, _ = q.shape
        attn = q @ k.transpose(-2, -1) + bias.to(q.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(b // nw, nw, h, n, n) + mask.to(q.dtype)[None, :, None]).view(b, h, n, n)
        attn = attn.softmax(-1)
        g = generator_on(self.dropout_generator, attn.device, self._generators)
        draw = torch.rand(attn.shape, generator=g, device=attn.device)
        attn = attn * (draw >= self.attn_drop).to(attn.dtype) / (1.0 - self.attn_drop)
        return attn @ v


class SwinTransformerBlock(nn.Module):
    """(Shifted-)window attention and an MLP, each pre-norm and residual; channels-last."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int], shift_size: Sequence[int],
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        nd = len(self.window_size)
        common = dict(device=device, dtype=dtype, generator=generator)
        self.norm1 = Norm[Norm.LAYER, nd](dim, device=device, dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias, attn_drop, drop, **common)
        self.norm2 = Norm[Norm.LAYER, nd](dim, device=device, dtype=dtype)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), drop, act="GELU", **common)

    def _attn_part(self, x: torch.Tensor, mask_matrix: torch.Tensor | None) -> torch.Tensor:
        spatial = x.shape[1:-1]
        window_size, shift_size = get_window_size(spatial, self.window_size, self.shift_size)
        x = self.norm1(x)
        pad = []
        for d, ws in zip(reversed(spatial), reversed(window_size)):  # F.pad lists the last dim first
            pad += [0, (ws - d % ws) % ws]
        if any(pad):
            x = F.pad(x, [0, 0, *pad])
        dims = (x.shape[0], *x.shape[1:-1])
        axes = tuple(range(1, len(spatial) + 1))
        shifted = any(s > 0 for s in shift_size)
        if shifted:
            x = torch.roll(x, shifts=[-s for s in shift_size], dims=axes)
        x = self.attn(window_partition(x, window_size), mask_matrix if shifted else None)
        x = window_reverse(x, window_size, dims)
        if shifted:
            x = torch.roll(x, shifts=list(shift_size), dims=axes)
        return x[(slice(None), *(slice(0, s) for s in spatial))]

    def forward(self, x: torch.Tensor, mask_matrix: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self._attn_part(x, mask_matrix)
        return x + self.mlp(self.norm2(x))


class PatchMergingV2(nn.Module):
    """Concatenate each 2^d neighbourhood's channels (odd sizes zero-padded at the end),
    LayerNorm, and a linear map to twice the input channels."""

    def __init__(self, dim: int, spatial_dims: int = 3, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dim = dim
        self.spatial_dims = spatial_dims
        self.reduction = linear(dim * 2**spatial_dims, 2 * dim, bias=False, device=device, dtype=dtype,
                                generator=generator)
        self.norm = Norm[Norm.LAYER, spatial_dims](dim * 2**spatial_dims, device=device, dtype=dtype)

    def _offsets(self, d: int) -> list[tuple[int, ...]]:
        if d == 2:
            # torch MONAI slices rows by the inner loop variable, so the 2-D channel
            # order is the transpose of the plain product order
            return [(0, 0), (1, 0), (0, 1), (1, 1)]
        return list(itertools.product((0, 1), repeat=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = []
        for s in reversed(x.shape[1:-1]):
            pad += [0, s % 2]
        if any(pad):
            x = F.pad(x, [0, 0, *pad])
        parts = [x[(slice(None), *(slice(o, None, 2) for o in offs))] for offs in self._offsets(self.spatial_dims)]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


class PatchMerging(PatchMergingV2):
    """The v0.9 merge, with its historical 3-D channel order; 2-D takes the V2 order."""

    def _offsets(self, d: int) -> list[tuple[int, ...]]:
        if d != 3:
            return super()._offsets(d)
        return [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]


MERGING_MODE = {"merging": PatchMerging, "mergingv2": PatchMergingV2}


class BasicLayer(nn.Module):
    """One Swin stage: ``depth`` blocks alternating unshifted and half-window-shifted
    windows, then the optional patch merging; channels-last."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int], mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0, attn_drop: float = 0.0, downsample=None,
                 spatial_dims: int = 3, device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(i // 2 for i in window_size)
        no_shift = tuple(0 for _ in window_size)
        common = dict(device=device, dtype=dtype, generator=generator)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, self.window_size, no_shift if i % 2 == 0 else self.shift_size,
                                 mlp_ratio, qkv_bias, drop, attn_drop, **common)
            for i in range(depth)
        ])
        self.downsample = downsample(dim=dim, spatial_dims=spatial_dims, **common) if downsample else None
        self._masks: dict = {}  # (padded dims, window, shift, device) -> mask on that device

    def _mask(self, spatial: Sequence[int], device: torch.device, traced: bool) -> torch.Tensor | None:
        window_size, shift_size = get_window_size(spatial, self.window_size, self.shift_size)
        if not any(shift_size):
            return None
        padded = tuple(-(-s // w) * w for s, w in zip(spatial, window_size))
        if traced:  # built in the traced graph, neither a constant of it nor kept
            return compute_mask(padded, window_size, shift_size, device)
        key = (padded, window_size, shift_size, device)
        if key not in self._masks:
            self._masks[key] = compute_mask(padded, window_size, shift_size, device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn_mask = self._mask(x.shape[1:-1], x.device, type(x) is not torch.Tensor)
        for blk in self.blocks:
            x = blk(x, attn_mask)
        return x if self.downsample is None else self.downsample(x)


class SwinTransformer(nn.Module):
    """Swin encoder: patch embedding and ``len(depths)`` stages ``layers1``, ``layers2``,
    ... (each a one-element ``ModuleList``, as torch MONAI names them). Channels-last in;
    returns the embedding and every stage's output, each layer-normed over its channels
    when ``normalize``."""

    def __init__(self, in_chans: int, embed_dim: int, window_size: Sequence[int], patch_size: Sequence[int],
                 depths: Sequence[int], num_heads: Sequence[int], mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0, patch_norm: bool = False,
                 spatial_dims: int = 3, downsample="merging", device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        downsample = MERGING_MODE[downsample] if isinstance(downsample, str) else downsample
        common = dict(device=device, dtype=dtype, generator=generator)
        self.num_layers = len(depths)
        self.embed_dim = embed_dim
        self.window_size = window_size
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, patch_norm, spatial_dims, **common)
        self.pos_drop = nn.Dropout(drop_rate)
        for i in range(self.num_layers):
            layer = BasicLayer(int(embed_dim * 2**i), depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                               drop_rate, attn_drop_rate, downsample, spatial_dims, **common)
            self.add_module(f"layers{i + 1}", nn.ModuleList([layer]))

    @staticmethod
    def _proj_out(x: torch.Tensor, normalize: bool) -> torch.Tensor:
        """Parameter-free layer norm over the channels (eps 1e-5): the normalised copy
        goes to the decoder, the raw tensor on to the next stage."""
        return F.layer_norm(x, x.shape[-1:]) if normalize else x

    def forward(self, x: torch.Tensor, normalize: bool = True) -> list[torch.Tensor]:
        x = self.pos_drop(self.patch_embed(x))
        outs = [self._proj_out(x, normalize)]
        for i in range(self.num_layers):
            x = getattr(self, f"layers{i + 1}")[0](x)
            outs.append(self._proj_out(x, normalize))
        return outs


class SwinUNETR(nn.Module):
    """Swin encoder and conv decoder: ``SwinUNETR(in_channels=1, out_channels=14,
    feature_size=24)`` is the bench's BTCV network, ``feature_size=48`` the BTCV bundle's;
    channel-first (B, C, *spatial) in and out, each spatial size a multiple of 32.
    ``device=None`` is the CUDA card; the weights are made on the CPU and then moved, so
    one seed gives the same weights on either device. ``dropout_path_rate`` and
    ``use_checkpoint`` are taken for the JAX package's signature and do nothing there or
    here (see the module docstring)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 2, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), feature_size: int = 24,
                 norm_name=("instance", {"affine": True}), drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 dropout_path_rate: float = 0.0, normalize: bool = True, use_checkpoint: bool = False,
                 spatial_dims: int = 3, downsample="merging",
                 window_size: Sequence[int] | int = 7, patch_size: Sequence[int] | int = 2, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        if feature_size % 12 != 0:
            raise ValueError("feature_size should be divisible by 12.")
        device = resolve_device(device)
        common = dict(device="cpu", dtype=dtype, generator=generator)
        self.normalize = normalize
        self.swinViT = SwinTransformer(in_channels, feature_size, ensure_tuple_rep(window_size, spatial_dims),
                                       ensure_tuple_rep(patch_size, spatial_dims), depths, num_heads,
                                       drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                                       spatial_dims=spatial_dims, downsample=downsample, **common)
        f = feature_size
        enc = dict(kernel_size=3, stride=1, norm_name=norm_name, res_block=True, **common)
        dec = dict(kernel_size=3, upsample_kernel_size=2, norm_name=norm_name, res_block=True, **common)
        self.encoder1 = UnetrBasicBlock(spatial_dims, in_channels, f, **enc)
        self.encoder2 = UnetrBasicBlock(spatial_dims, f, f, **enc)
        self.encoder3 = UnetrBasicBlock(spatial_dims, 2 * f, 2 * f, **enc)
        self.encoder4 = UnetrBasicBlock(spatial_dims, 4 * f, 4 * f, **enc)
        self.encoder10 = UnetrBasicBlock(spatial_dims, 16 * f, 16 * f, **enc)
        self.decoder5 = UnetrUpBlock(spatial_dims, 16 * f, 8 * f, **dec)
        self.decoder4 = UnetrUpBlock(spatial_dims, 8 * f, 4 * f, **dec)
        self.decoder3 = UnetrUpBlock(spatial_dims, 4 * f, 2 * f, **dec)
        self.decoder2 = UnetrUpBlock(spatial_dims, 2 * f, f, **dec)
        self.decoder1 = UnetrUpBlock(spatial_dims, f, f, **dec)
        self.out = UnetOutBlock(spatial_dims, f, out_channels, **common)
        self.to(device)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        x_in = channels_last(x_in)
        hidden = [h.movedim(-1, 1) for h in self.swinViT(x_in.movedim(1, -1), self.normalize)]
        enc0 = self.encoder1(x_in)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec4 = self.encoder10(hidden[4])
        dec3 = self.decoder5(dec4, hidden[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))


def filter_swinunetr(key: str, value):
    """Key filter for the public Disruptive-Autoencoders SSL pretrained weights
    (arXiv:2307.16896): maps ``encoder.*`` entries onto ``swinViT.*`` and drops the
    decoder and mask-token entries. Returns ``(new_key, value)`` or None."""
    if key in ["encoder.mask_token", "encoder.norm.weight", "encoder.norm.bias", "out.conv.conv.weight",
               "out.conv.conv.bias"]:
        return None
    if key[:8] == "encoder.":
        if key[8:19] == "patch_embed":
            return "swinViT." + key[8:], value
        return "swinViT." + key[8:18] + key[20:], value
    return None
