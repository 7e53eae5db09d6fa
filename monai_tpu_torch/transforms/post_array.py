"""Activations and AsDiscrete (counterpart of monai_tpu/transforms/post_array.py), on
channel-first single samples: the softmax, the argmax and the one-hot encoding of the
bundles' postprocessing."""
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
    """Argmax over the channel axis, kept with size 1, where ``argmax`` is set; then a
    one-hot encoding into ``to_onehot`` channels (of a one-channel map of class indices)
    where it is given; as float32."""

    def __init__(self, argmax: bool = False, to_onehot: int | None = None):
        if isinstance(to_onehot, bool):
            raise ValueError("`to_onehot=True/False` is deprecated, please use `to_onehot=num_classes`.")
        self.argmax = argmax
        self.to_onehot = to_onehot

    def __call__(self, img: Any, argmax: bool | None = None, to_onehot: int | None = None):
        data = img.data if isinstance(img, MetaImage) else img
        out = torch.argmax(data, dim=0, keepdim=True) if (self.argmax if argmax is None else argmax) else data
        to_onehot = self.to_onehot if to_onehot is None else to_onehot
        if to_onehot is not None:
            if not isinstance(to_onehot, int) or isinstance(to_onehot, bool):
                raise ValueError(f"the number of classes for One-Hot must be an integer, got {type(to_onehot)}.")
            if out.shape[0] != 1:
                raise AssertionError("labels should have a channel with length equal to one.")
            out = torch.nn.functional.one_hot(out[0].long(), to_onehot).movedim(-1, 0)
        out = out.float()
        return img.new_like(out) if isinstance(img, MetaImage) else out
