"""Activations, AsDiscrete, MeanEnsemble and VoteEnsemble (counterparts of the classes in
monai_tpu/transforms/post_array.py), on channel-first single samples: the sigmoid, the
softmax, the argmax, the one-hot encoding and the threshold of the bundles'
postprocessing, and the Auto3DSeg ensemble's mean or vote over its members' outputs, on
the outputs' device."""
from __future__ import annotations

import warnings
from collections.abc import Sequence
from typing import Any

import torch

from ..data.meta_image import MetaImage
from ..networks.utils import one_hot
from .transform import Transform

__all__ = ["Activations", "AsDiscrete", "Ensemble", "MeanEnsemble", "VoteEnsemble"]


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


class Ensemble:
    """The members' outputs stacked on a new first axis, and the result given the first
    member's meta where it is a ``MetaImage``."""

    @staticmethod
    def get_stacked_torch(img: Any) -> torch.Tensor:
        if isinstance(img, Sequence):
            return torch.stack([torch.as_tensor(i.data if isinstance(i, MetaImage) else i) for i in img])
        return img.data if isinstance(img, MetaImage) else torch.as_tensor(img)

    @staticmethod
    def post_convert(out: torch.Tensor, orig: Any):
        ref = orig[0] if isinstance(orig, Sequence) else orig
        return ref.new_like(out) if isinstance(ref, MetaImage) else out


class MeanEnsemble(Ensemble, Transform):
    """The mean over the members, each scaled by its weight over the weights' mean where
    ``weights`` (one a member, or one a member and channel) are given."""

    def __init__(self, weights: Sequence[float] | None = None):
        self.weights = None if weights is None else torch.as_tensor(weights, dtype=torch.float32)

    def __call__(self, img: Any):
        stacked = self.get_stacked_torch(img)
        if self.weights is not None:
            w = self.weights.to(device=stacked.device, dtype=stacked.dtype)
            w = w.reshape(*w.shape, *(1,) * (stacked.ndim - w.ndim))
            stacked = stacked * w / w.mean(dim=0, keepdim=True)
        return self.post_convert(stacked.mean(dim=0), img)


class VoteEnsemble(Ensemble, Transform):
    """A majority vote: with ``num_classes``, of one-channel label maps (the argmax of the
    members' one-hot mean, one channel); without, of one-hot or binary outputs (1 where
    at least half the members say 1), as float32."""

    def __init__(self, num_classes: int | None = None):
        self.num_classes = num_classes

    def __call__(self, img: Any):
        stacked = self.get_stacked_torch(img)
        has_ch_dim = True
        if self.num_classes is not None:
            if stacked.ndim > 1 and stacked.shape[1] > 1:
                warnings.warn("no need to specify num_classes for One-Hot format data.")
            else:
                has_ch_dim = stacked.ndim > 1
                stacked = one_hot(stacked if stacked.ndim > 1 else stacked[:, None], self.num_classes, dim=1)
        out = stacked.float().mean(dim=0)
        if self.num_classes is not None:
            out = torch.argmax(out, dim=0, keepdim=has_ch_dim).float()
        else:
            out = (out >= 0.5).float()
        return self.post_convert(out, img)
