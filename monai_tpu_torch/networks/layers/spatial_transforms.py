"""Spatial transform layers (counterpart of monai_tpu/networks/layers/spatial_transforms.py):
``normalize_transform`` and ``to_norm_affine``, which move a voxel affine into torch's
normalised [-1, 1] coordinates, and ``AffineTransform``, a batch of affines applied to
images as torch's ``affine_grid`` and ``grid_sample`` compose them, sampled by
``ops.resample.grid_pull`` (any order and bound). ``grid_pull``, ``grid_push``,
``grid_count`` and ``grid_grad`` are re-exported from ``ops/resample.py``; autograd
differentiates the pull and the push, so no backward is written by hand.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ...ops.resample import grid_count, grid_grad, grid_pull, grid_push, resolve_mode
from ...utils.misc import ensure_tuple

__all__ = ["AffineTransform", "normalize_transform", "to_norm_affine", "grid_pull", "grid_grad", "grid_push",
           "grid_count"]


def normalize_transform(shape, align_corners: bool = False, zero_centered: bool = False,
                        device=None) -> torch.Tensor:
    """The float64 affine from voxel indices of ``shape`` to normalised [-1, 1] coordinates."""
    size = torch.as_tensor([float(s) for s in shape], dtype=torch.float64, device=device)
    if align_corners:
        norm = torch.where(size <= 1.0, torch.full_like(size, 2.0), size)
        diag = 2.0 / (norm if zero_centered else norm - 1.0)
    else:
        norm = torch.where(size <= 0.0, torch.full_like(size, 2.0), size)
        diag = 2.0 / ((norm - 1.0) if zero_centered else norm)
    mat = torch.diag(torch.cat([diag, torch.ones(1, dtype=torch.float64, device=size.device)]))
    if not zero_centered:
        mat[:-1, -1] = -1.0 if align_corners else 1.0 / size - 1.0
    return mat


def to_norm_affine(affine: torch.Tensor, src_size, dst_size, align_corners: bool = False,
                   zero_centered: bool = False) -> torch.Tensor:
    """A batch of voxel affines (B, D + 1, D + 1) in normalised coordinates, float32."""
    affine = torch.as_tensor(affine)
    src = normalize_transform(src_size, align_corners, zero_centered, affine.device)
    dst = normalize_transform(dst_size, align_corners, zero_centered, affine.device)
    return (src[None] @ affine.double() @ torch.linalg.inv(dst)[None]).float()


class AffineTransform(nn.Module):
    """Apply a batch of affines ``theta`` to images (B, C, *spatial), 2-D or 3-D, as torch's
    ``affine_grid`` followed by ``grid_sample`` (``reverse_indexing``: theta in (x, y[, z])
    order, x the last axis). Unless ``normalized``, theta maps voxel indices and is moved
    into normalised coordinates first. It has no parameters."""

    def __init__(self, spatial_size: Sequence[int] | int | None = None, normalized: bool = False,
                 mode: str = "bilinear", padding_mode: str = "zeros", align_corners: bool = True,
                 reverse_indexing: bool = True, zero_centered: bool | None = None):
        super().__init__()
        self.spatial_size = ensure_tuple(spatial_size) if spatial_size is not None else None
        self.normalized = normalized
        self.mode = mode
        self.padding_mode = padding_mode
        self.align_corners = align_corners
        self.reverse_indexing = reverse_indexing
        if zero_centered is not None and normalized:
            raise ValueError("`normalized=True` is not compatible with `zero_centered`.")
        self.zero_centered = bool(zero_centered) if zero_centered is not None else False

    def forward(self, src: torch.Tensor, theta: torch.Tensor,
                spatial_size: Sequence[int] | int | None = None) -> torch.Tensor:
        theta = torch.as_tensor(theta, device=src.device)
        if theta.ndim == 2:
            theta = theta[None]
        sr = src.ndim - 2
        if sr not in (2, 3):
            raise ValueError(f"Unsupported src dimension: {sr}.")
        if theta.shape[1] == sr:  # square and homogeneous
            bottom = torch.zeros((theta.shape[0], 1, sr + 1), dtype=theta.dtype, device=theta.device)
            bottom[:, 0, sr] = 1.0
            theta = torch.cat([theta, bottom], dim=1)
        src_spatial = tuple(src.shape[2:])
        dst_spatial = src_spatial
        if self.spatial_size is not None:
            dst_spatial = self.spatial_size
        if spatial_size is not None:
            dst_spatial = ensure_tuple(spatial_size)
        if not self.normalized:
            theta = to_norm_affine(theta, src_spatial, dst_spatial, align_corners=False,
                                   zero_centered=self.zero_centered)
        if self.reverse_indexing:
            rev = list(range(sr - 1, -1, -1))
            theta = theta.clone()
            theta[:, :sr] = theta[:, rev]
            theta[:, :, :sr] = theta[:, :, rev]
        b = src.shape[0]
        if theta.shape[0] == 1 and b > 1:
            theta = theta.expand(b, -1, -1)
        if theta.shape[0] != b:
            raise ValueError(f"affine and image batch dimension must match, got affine={theta.shape[0]} image={b}.")
        # torch's affine_grid: base coordinates in (x, y[, z]) order, x the last spatial axis
        axes = []
        for s in dst_spatial[::-1]:
            if self.align_corners:
                axes.append(torch.linspace(-1.0, 1.0, s, device=src.device))
            else:
                axes.append((torch.arange(s, device=src.device) * 2 + 1) / s - 1.0)
        mesh = torch.meshgrid(*axes[::-1], indexing="ij")
        base = torch.stack(list(mesh[::-1]) + [torch.ones(tuple(dst_spatial), device=src.device)], dim=-1)
        flat = base.reshape(-1, sr + 1).float()
        coords = torch.einsum("bij,pj->bpi", theta[:, :sr].float(), flat).flip(-1)  # index (i, j[, k]) order
        scale = [(s - 1) / 2.0 if self.align_corners else s / 2.0 for s in src_spatial]
        shift = [(s - 1) / 2.0 for s in src_spatial]
        vox = coords * torch.tensor(scale, device=src.device) + torch.tensor(shift, device=src.device)
        vox = vox.reshape((b, *dst_spatial, sr))
        order = resolve_mode(self.mode)
        return torch.stack([grid_pull(src[i], vox[i], interpolation=order, bound=self.padding_mode,
                                      align_corners=self.align_corners) for i in range(b)])
