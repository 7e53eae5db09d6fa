"""Bilateral filtering layers (counterpart of monai_tpu/networks/layers/filtering.py;
reference: monai/networks/layers/filtering.py:23,66,184,349).

``BilateralFilter`` and ``PHLFilter`` are functional: they run on their input's device.
The trainable filters hold their sigmas as parameters (on the card unless ``device``
says otherwise) and differentiate through them with autograd; their weighted sum is
plain PyTorch, as the JAX package runs it through XLA and not through the bilateral
kernel. Per-axis spatial sigmas are independent parameters, as in the reference; each
channel is filtered with the shared sigmas.
"""
from __future__ import annotations

import itertools
from typing import Any

import torch
from torch import nn

from ...ops.bilateral import edge_pad, filter_radius
from ...ops.filtering import bilateral_filter, phl_filter
from ...utils.backend import resolve_device

__all__ = ["BilateralFilter", "PHLFilter", "TrainableBilateralFilter", "TrainableJointBilateralFilter"]


class BilateralFilter:
    """Functional wrapper (reference: filtering.py:23); ``fast_approx`` takes the
    bilateral grid, else the brute-force stencil (the CUDA kernel on the card)."""

    @staticmethod
    def apply(input: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
              fast_approx: bool = True) -> torch.Tensor:
        return bilateral_filter(input, spatial_sigma, color_sigma, fast_approx)

    def __call__(self, input, spatial_sigma: float = 5.0, color_sigma: float = 0.5, fast_approx: bool = True):
        return self.apply(input, spatial_sigma, color_sigma, fast_approx)


class PHLFilter:
    """Guided filter with arbitrary feature vectors (reference: filtering.py:66)."""

    @staticmethod
    def apply(input: torch.Tensor, features: torch.Tensor, sigmas=None) -> torch.Tensor:
        return phl_filter(input, features, sigmas)

    def __call__(self, input, features, sigmas=None):
        return self.apply(input, features, sigmas)


def _per_axis_sigmas(sigma: torch.Tensor, sd: int) -> list[torch.Tensor]:
    """A length-1 or length-sd sigma vector as one scalar per spatial axis."""
    if sigma.shape[0] == sd:
        return [sigma[d] for d in range(sd)]
    if sigma.shape[0] == 1:
        return [sigma[0]] * sd
    raise ValueError(f"spatial_sigma has {sigma.shape[0]} entries for {sd} spatial dims.")


def _bilateral_weighted_sum(img: torch.Tensor, guidance: torch.Tensor, sigmas: list[torch.Tensor],
                            color_sigma: torch.Tensor, truncate: float = 2.0) -> torch.Tensor:
    """The trainable (joint) bilateral core: per-axis Gaussian spatial weights times a
    per-voxel Gaussian range weight on the guidance, edge padding; each axis's radius
    from its sigma's value. Differentiable in the input, the guidance and the sigmas."""
    radii = [filter_radius(float(s.detach()), truncate) for s in sigmas]
    spatial = img.shape[2:]
    padded = edge_pad(img, radii)
    padded_g = padded if guidance is img else edge_pad(guidance, radii)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for off in itertools.product(*[range(-r, r + 1) for r in radii]):
        w_s = torch.exp(sum((-0.5 * float(o * o)) / (s ** 2) for o, s in zip(off, sigmas)))
        window = (slice(None), slice(None)) + tuple(slice(r + o, r + o + n) for o, r, n in zip(off, radii, spatial))
        shifted = padded[window]
        shifted_g = shifted if guidance is img else padded_g[window]
        w = w_s * torch.exp(-0.5 * ((shifted_g - guidance) / color_sigma) ** 2)
        num = num + w * shifted
        den = den + w
    return num / torch.clamp(den, min=1e-8)


class _TrainableFilter(nn.Module):
    def __init__(self, spatial_sigma: Any, color_sigma: float = 0.5, device: Any = None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(spatial_sigma, (int, float)):
            spatial_sigma = [float(spatial_sigma)]
        self.sigma_spatial = nn.Parameter(torch.tensor(spatial_sigma, dtype=torch.float32, device=dev).reshape(-1))
        self.sigma_color = nn.Parameter(torch.tensor(color_sigma, dtype=torch.float32, device=dev))

    @property
    def sigma_x(self) -> torch.Tensor:
        return self.sigma_spatial[0]

    @property
    def sigma_y(self) -> torch.Tensor:
        return self.sigma_spatial[1] if self.sigma_spatial.shape[0] > 1 else self.sigma_spatial[0]

    @property
    def sigma_z(self) -> torch.Tensor:
        return self.sigma_spatial[2] if self.sigma_spatial.shape[0] > 2 else self.sigma_spatial[0]


class TrainableBilateralFilter(_TrainableFilter):
    """Bilateral filter with independently learnable per-axis spatial sigmas (length 1 or
    one per spatial axis) and a learnable color sigma (reference: filtering.py:184)."""

    def forward(self, input_tensor: torch.Tensor) -> torch.Tensor:
        sigmas = _per_axis_sigmas(self.sigma_spatial, input_tensor.ndim - 2)
        return _bilateral_weighted_sum(input_tensor, input_tensor, sigmas, self.sigma_color)


class TrainableJointBilateralFilter(_TrainableFilter):
    """Joint bilateral filter: the range weights come from a guidance image of the
    input's shape (reference: filtering.py:349)."""

    def forward(self, input_tensor: torch.Tensor, guidance_tensor: torch.Tensor) -> torch.Tensor:
        if input_tensor.shape != guidance_tensor.shape:
            raise ValueError("Shape of input image must equal shape of guidance image.")
        sigmas = _per_axis_sigmas(self.sigma_spatial, input_tensor.ndim - 2)
        return _bilateral_weighted_sum(input_tensor, guidance_tensor, sigmas, self.sigma_color)
