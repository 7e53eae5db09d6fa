"""ScaleIntensityRange, ScaleIntensity, NormalizeIntensity, RandShiftIntensity and
RandScaleIntensity (counterpart of monai_tpu/transforms/intensity_array.py)."""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import torch

from ..data.meta_image import MetaImage
from ..utils.backend import get_torch_dtype
from .transform import RandomizableTransform, Transform

__all__ = ["NormalizeIntensity", "RandScaleIntensity", "RandShiftIntensity", "ScaleIntensity", "ScaleIntensityRange"]


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


class ScaleIntensity(Transform):
    """Rescale linearly onto [minv, maxv] (a constant image to minv; only maxv given: the
    [0, 1] map times it; only minv: plus it), or, with both None, times 1 + ``factor``; over
    the whole image or each channel (``channel_wise``), in ``dtype`` (float32)."""

    def __init__(self, minv: float | None = 0.0, maxv: float | None = 1.0, factor: float | None = None,
                 channel_wise: bool = False, dtype=torch.float32):
        self.minv, self.maxv, self.factor = minv, maxv, factor
        self.channel_wise = channel_wise
        self.dtype = get_torch_dtype(dtype)

    def _rescale(self, x: torch.Tensor) -> torch.Tensor:
        if self.minv is None and self.maxv is None:
            return (x * (1 + (self.factor or 0.0))).to(self.dtype)
        mina, maxa = x.min(), x.max()
        denom = maxa - mina
        norm = torch.zeros_like(x) if denom == 0 else (x - mina) / denom
        if self.minv is None:
            return (norm * self.maxv).to(self.dtype)
        if self.maxv is None:
            return (norm + self.minv).to(self.dtype)
        return (norm * (self.maxv - self.minv) + self.minv).to(self.dtype)

    def __call__(self, img: Any):
        x = (img.data if isinstance(img, MetaImage) else img).to(self.dtype)
        out = torch.stack([self._rescale(c) for c in x]) if self.channel_wise else self._rescale(x)
        return img.new_like(out) if isinstance(img, MetaImage) else out


class RandShiftIntensity(RandomizableTransform):
    """With probability ``prob``, img + an offset drawn uniformly from ``offsets`` (a pair,
    or ±a number), in the image's type; ``channel_wise`` draws one offset a channel (after
    the probability, in channel order). A call's ``factor`` scales the offset. ``safe`` is
    taken for the JAX package's signature, which clips nothing for it either."""

    def __init__(self, offsets: tuple[float, float] | float, safe: bool = False, prob: float = 0.1,
                 channel_wise: bool = False):
        RandomizableTransform.__init__(self, prob)
        if isinstance(offsets, (int, float)):
            self.offsets = (min(-offsets, offsets), max(-offsets, offsets))
        elif len(offsets) != 2:
            raise ValueError(f"offsets should be a number or pair of numbers, got {offsets}.")
        else:
            self.offsets = (min(offsets), max(offsets))
        self.channel_wise = channel_wise
        self._offset = self.offsets[0]

    def randomize(self, data: Any = None) -> None:
        super().randomize(None)
        if not self._do_transform:
            return
        if self.channel_wise:
            self._offset = [self.R.uniform(low=self.offsets[0], high=self.offsets[1]) for _ in range(data.shape[0])]
        else:
            self._offset = self.R.uniform(low=self.offsets[0], high=self.offsets[1])

    def __call__(self, img: Any, factor: float | None = None, randomize: bool = True):
        x = img.data if isinstance(img, MetaImage) else img
        if randomize:
            self.randomize(x)
        if not self._do_transform:
            return img
        scale = 1.0 if factor is None else factor
        if self.channel_wise:
            offset = torch.tensor([o * scale for o in self._offset], dtype=x.dtype, device=x.device)
            out = (x + offset.reshape(-1, *(1,) * (x.ndim - 1))).to(x.dtype)
        else:
            out = (x + self._offset * scale).to(x.dtype)
        return img.new_like(out) if isinstance(img, MetaImage) else out


class NormalizeIntensity(Transform):
    """(img - subtrahend) / divisor in float32, by default the image's mean and (biased)
    standard deviation, a divisor of 0 taken as 1. ``nonzero``: over the nonzero voxels
    only, the others left as they are. ``channel_wise``: each channel on its own (and
    ``subtrahend`` and ``divisor`` a value a channel). The statistics are summed in
    float64."""

    def __init__(self, subtrahend: Sequence[float] | float | None = None,
                 divisor: Sequence[float] | float | None = None, nonzero: bool = False, channel_wise: bool = False,
                 dtype=torch.float32):
        self.subtrahend = subtrahend
        self.divisor = divisor
        self.nonzero = nonzero
        self.channel_wise = channel_wise
        self.dtype = dtype

    def _normalize(self, x: torch.Tensor, sub=None, div=None) -> torch.Tensor:
        mask = x != 0 if self.nonzero else None
        if sub is None or div is None:
            xd = x.double() if mask is None else torch.where(mask, x.double(), 0.0)
            count = x.numel() if mask is None else mask.sum().clamp_min(1)
            mean = xd.sum() / count
            sub = mean if sub is None else sub
            if div is None:
                dev = xd - mean if mask is None else torch.where(mask, xd - mean, 0.0)
                div = ((dev * dev).sum() / count).sqrt()
        sub, div = (torch.as_tensor(v, dtype=torch.float64, device=x.device) for v in (sub, div))
        div = torch.where(div == 0, 1.0, div)
        out = (x - sub.float()) / div.float()
        return out if mask is None else torch.where(mask, out, x)

    def __call__(self, img: Any):
        x = (img.data if isinstance(img, MetaImage) else img).float()
        if self.channel_wise:
            subs = [None] * x.shape[0] if self.subtrahend is None else self.subtrahend
            divs = [None] * x.shape[0] if self.divisor is None else self.divisor
            out = torch.stack([self._normalize(c, s, d) for c, s, d in zip(x, subs, divs)])
        else:
            out = self._normalize(x, self.subtrahend, self.divisor)
        out = out.to(get_torch_dtype(self.dtype))
        return img.new_like(out) if isinstance(img, MetaImage) else out


class RandScaleIntensity(RandomizableTransform):
    """With probability ``prob``, img * (1 + a factor drawn uniformly from ``factors``, a
    pair or ±a number), one factor a channel where ``channel_wise``; in float32. The draws
    are the JAX package's: the probability, then the factor(s)."""

    def __init__(self, factors: tuple[float, float] | float, prob: float = 0.1, channel_wise: bool = False,
                 dtype=torch.float32):
        RandomizableTransform.__init__(self, prob)
        if isinstance(factors, (int, float)):
            self.factors = (min(-factors, factors), max(-factors, factors))
        elif len(factors) != 2:
            raise ValueError(f"factors should be a number or pair of numbers, got {factors}.")
        else:
            self.factors = (min(factors), max(factors))
        self.factor: float | list[float] = self.factors[0]
        self.channel_wise = channel_wise
        self.dtype = dtype

    def randomize(self, data: Any = None) -> None:
        super().randomize(None)
        if self._do_transform:
            if self.channel_wise and data is not None:
                self.factor = [self.R.uniform(low=self.factors[0], high=self.factors[1]) for _ in range(data.shape[0])]
            else:
                self.factor = self.R.uniform(low=self.factors[0], high=self.factors[1])

    def __call__(self, img: Any, randomize: bool = True):
        if randomize:
            self.randomize(img.data if isinstance(img, MetaImage) else img)
        if not self._do_transform:
            return img
        dtype = get_torch_dtype(self.dtype)
        x = (img.data if isinstance(img, MetaImage) else img).to(dtype)
        if isinstance(self.factor, list):
            scale = torch.tensor([1.0 + f for f in self.factor], dtype=dtype, device=x.device)
            out = x * scale.view(-1, *([1] * (x.ndim - 1)))
        else:
            out = x * (1.0 + self.factor)
        out = out.to(dtype)
        return img.new_like(out) if isinstance(img, MetaImage) else out
