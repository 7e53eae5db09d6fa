"""Activations and AsDiscrete (counterpart of monai_tpu/transforms/post_array.py), on
channel-first single samples: the sigmoid, the softmax, the argmax, the one-hot encoding
and the threshold of the bundles' postprocessing."""
from __future__ import annotations

from typing import Any

import torch

from ..data.meta_image import MetaImage
from .transform import Transform

__all__ = ["Activations", "AsDiscrete"]


class Activations(Transform):
    """The sigmoid, where ``sigmoid`` is set, or the softmax over the channel axis, where
    ``softmax`` is set."""

    def __init__(self, sigmoid: bool = False, softmax: bool = False):
        self.sigmoid = sigmoid
        self.softmax = softmax

    def __call__(self, img: Any, sigmoid: bool | None = None, softmax: bool | None = None):
        if sigmoid and softmax:
            raise ValueError("Incompatible values: sigmoid=True and softmax=True.")
        data = img.data if isinstance(img, MetaImage) else img
        if self.sigmoid if sigmoid is None else sigmoid:
            out = torch.sigmoid(data)
        elif self.softmax if softmax is None else softmax:
            out = torch.softmax(data, dim=0)
        else:
            out = data
        return img.new_like(out) if isinstance(img, MetaImage) else out


class AsDiscrete(Transform):
    """Argmax over the channel axis, kept with size 1, where ``argmax`` is set; then a
    one-hot encoding into ``to_onehot`` channels (of a one-channel map of class indices, or
    of one class index, as a decollated classification label) where it is given; then 1 where the value is at least ``threshold``, 0 elsewhere,
    where it is given; as float32."""

    def __init__(self, argmax: bool = False, to_onehot: int | None = None, threshold: float | None = None):
        if isinstance(to_onehot, bool):
            raise ValueError("`to_onehot=True/False` is deprecated, please use `to_onehot=num_classes`.")
        self.argmax = argmax
        self.to_onehot = to_onehot
        self.threshold = threshold

    def __call__(self, img: Any, argmax: bool | None = None, to_onehot: int | None = None,
                 threshold: float | None = None):
        data = img.data if isinstance(img, MetaImage) else torch.as_tensor(img)
        out = torch.argmax(data, dim=0, keepdim=True) if (self.argmax if argmax is None else argmax) else data
        to_onehot = self.to_onehot if to_onehot is None else to_onehot
        if to_onehot is not None:
            if not isinstance(to_onehot, int) or isinstance(to_onehot, bool):
                raise ValueError(f"the number of classes for One-Hot must be an integer, got {type(to_onehot)}.")
            if out.ndim == 0:  # a class index, as a classifier's label: one channel
                out = out[None]
            if out.shape[0] != 1:
                raise AssertionError("labels should have a channel with length equal to one.")
            out = torch.nn.functional.one_hot(out[0].long(), to_onehot).movedim(-1, 0)
        threshold = self.threshold if threshold is None else threshold
        if threshold is not None:
            out = out >= threshold
        out = out.float()
        return img.new_like(out) if isinstance(img, MetaImage) else out
