"""ScaleIntensityRange and RandShiftIntensity (counterpart of
monai_tpu/transforms/intensity_array.py)."""
from __future__ import annotations

from typing import Any

import torch

from ..data.meta_image import MetaImage
from ..utils.backend import get_torch_dtype
from .transform import RandomizableTransform, Transform

__all__ = ["RandShiftIntensity", "ScaleIntensityRange"]


class ScaleIntensityRange(Transform):
    """Map [a_min, a_max] linearly onto [b_min, b_max] in float32, optionally clipped to it."""

    def __init__(self, a_min: float, a_max: float, b_min: float | None = None, b_max: float | None = None,
                 clip: bool = False, dtype=torch.float32):
        self.a_min, self.a_max, self.b_min, self.b_max = a_min, a_max, b_min, b_max
        self.clip = clip
        self.dtype = dtype

    def __call__(self, img: Any):
        x = (img.data if isinstance(img, MetaImage) else img).float()
        if self.a_max - self.a_min == 0.0:
            x = x - self.a_min if self.b_min is None else x - self.a_min + self.b_min
        else:
            x = (x - self.a_min) / (self.a_max - self.a_min)
            if self.b_min is not None and self.b_max is not None:
                x = x * (self.b_max - self.b_min) + self.b_min
            if self.clip:
                x = x.clamp(self.b_min, self.b_max)
            x = x.to(get_torch_dtype(self.dtype))
        return img.new_like(x) if isinstance(img, MetaImage) else x


class RandShiftIntensity(RandomizableTransform):
    """With probability ``prob``, img + an offset drawn uniformly from ``offsets`` (a pair,
    or ±a number), in the image's type. The JAX package's ``channel_wise`` is not ported."""

    def __init__(self, offsets: tuple[float, float] | float, prob: float = 0.1):
        RandomizableTransform.__init__(self, prob)
        if isinstance(offsets, (int, float)):
            self.offsets = (min(-offsets, offsets), max(-offsets, offsets))
        elif len(offsets) != 2:
            raise ValueError(f"offsets should be a number or pair of numbers, got {offsets}.")
        else:
            self.offsets = (min(offsets), max(offsets))
        self._offset = self.offsets[0]

    def randomize(self, data: Any = None) -> None:
        super().randomize(None)
        if self._do_transform:
            self._offset = self.R.uniform(low=self.offsets[0], high=self.offsets[1])

    def __call__(self, img: Any, randomize: bool = True):
        if randomize:
            self.randomize()
        if not self._do_transform:
            return img
        x = img.data if isinstance(img, MetaImage) else img
        out = (x + self._offset).to(x.dtype)
        return img.new_like(out) if isinstance(img, MetaImage) else out
