"""Conditional random field with mean-field iterations over the PHL filter (counterpart
of monai_tpu/networks/blocks/crf.py; reference: monai/networks/blocks/crf.py:23)."""
from __future__ import annotations

import torch

from ...ops.filtering import phl_filter

__all__ = ["CRF"]


class CRF:
    """Mean-field CRF refinement of segmentation logits (reference: crf.py:23); runs on
    its inputs' device."""

    def __init__(self, iterations: int = 5, bilateral_weight: float = 1.0, gaussian_weight: float = 1.0,
                 bilateral_spatial_sigma: float = 5.0, bilateral_color_sigma: float = 0.5,
                 gaussian_spatial_sigma: float = 5.0, update_factor: float = 3.0, compatibility_matrix=None):
        self.iterations = iterations
        self.bilateral_weight = bilateral_weight
        self.gaussian_weight = gaussian_weight
        self.bilateral_spatial_sigma = bilateral_spatial_sigma
        self.bilateral_color_sigma = bilateral_color_sigma
        self.gaussian_spatial_sigma = gaussian_spatial_sigma
        self.update_factor = update_factor
        self.compatibility_matrix = compatibility_matrix

    def __call__(self, input_tensor: torch.Tensor, reference_tensor: torch.Tensor) -> torch.Tensor:
        """input_tensor: (B, C, *spatial) logits; reference_tensor: (B, F, *spatial) image."""
        spatial = input_tensor.shape[2:]
        dev = input_tensor.device
        mesh = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev) for s in spatial],
                                          indexing="ij"))
        spatial_features = mesh[None].expand((input_tensor.shape[0], *mesh.shape))
        bilateral_features = torch.cat([spatial_features / self.bilateral_spatial_sigma,
                                        reference_tensor / self.bilateral_color_sigma], dim=1)
        gaussian_features = spatial_features / self.gaussian_spatial_sigma
        compat = None if self.compatibility_matrix is None else torch.as_tensor(
            self.compatibility_matrix, dtype=torch.float32, device=dev)
        output = torch.softmax(input_tensor, dim=1)
        for _ in range(self.iterations):
            combined = (self.bilateral_weight * phl_filter(output, bilateral_features)
                        + self.gaussian_weight * phl_filter(output, gaussian_features))
            if compat is not None:
                flat = combined.reshape(combined.shape[0], combined.shape[1], -1)
                combined = torch.einsum("ij,bjn->bin", compat, flat).reshape(combined.shape)
            output = torch.softmax(input_tensor + self.update_factor * combined, dim=1)
        return output
