"""Activations and AsDiscrete (counterpart of monai_tpu/transforms/post_array.py), on
channel-first single samples: the softmax and the argmax the Spleen bundle uses."""
from __future__ import annotations

from typing import Any

import torch

from ..data.meta_image import MetaImage
from .transform import Transform

__all__ = ["Activations", "AsDiscrete"]


class Activations(Transform):
    """Softmax over the channel axis, where ``softmax`` is set."""

    def __init__(self, softmax: bool = False):
        self.softmax = softmax

    def __call__(self, img: Any, softmax: bool | None = None):
        data = img.data if isinstance(img, MetaImage) else img
        out = torch.softmax(data, dim=0) if (self.softmax if softmax is None else softmax) else data
        return img.new_like(out) if isinstance(img, MetaImage) else out


class AsDiscrete(Transform):
    """Argmax over the channel axis, kept with size 1, as float32, where ``argmax`` is set."""

    def __init__(self, argmax: bool = False):
        self.argmax = argmax

    def __call__(self, img: Any, argmax: bool | None = None):
        data = img.data if isinstance(img, MetaImage) else img
        out = torch.argmax(data, dim=0, keepdim=True) if (self.argmax if argmax is None else argmax) else data
        out = out.float()
        return img.new_like(out) if isinstance(img, MetaImage) else out
