"""Dice losses (counterpart of monai_tpu/losses/dice.py: ``DiceLoss`` and the general
path of ``DiceCELoss``).

Plain PyTorch on (B, C, *spatial) tensors. The JAX package's two-class rewrite of
DiceCELoss on the logit difference and its channels-last inputs are TPU lane-density
measures and are not ported: the general path computes the same loss.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F

from ..networks.utils import one_hot
from ..utils.enums import LossReduction

__all__ = ["DiceCELoss", "DiceLoss"]


def _reduce(f: torch.Tensor, reduction: str) -> torch.Tensor:
    r = str(reduction)
    if r == "mean":
        return f.mean()
    if r == "sum":
        return f.sum()
    return f


class DiceLoss:
    """Soft Dice loss. input: (B, C, *spatial) logits or probabilities; target:
    (B, C, *spatial) or (B, 1, *spatial) labels."""

    def __init__(self, include_background: bool = True, to_onehot_y: bool = False, sigmoid: bool = False,
                 softmax: bool = False, other_act: Callable | None = None, squared_pred: bool = False,
                 jaccard: bool = False, reduction: str = LossReduction.MEAN, smooth_nr: float = 1e-5,
                 smooth_dr: float = 1e-5, batch: bool = False, weight: Sequence[float] | float | None = None):
        if int(sigmoid) + int(softmax) + int(other_act is not None) > 1:
            raise ValueError("Incompatible values: more than 1 of [sigmoid=True, softmax=True, other_act].")
        self.include_background = include_background
        self.to_onehot_y = to_onehot_y
        self.sigmoid = sigmoid
        self.softmax = softmax
        self.other_act = other_act
        self.squared_pred = squared_pred
        self.jaccard = jaccard
        self.reduction = LossReduction(str(reduction))
        self.smooth_nr = float(smooth_nr)
        self.smooth_dr = float(smooth_dr)
        self.batch = batch
        self.weight = weight

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.sigmoid:
            input = torch.sigmoid(input)
        n_pred_ch = input.shape[1]
        if self.softmax and n_pred_ch != 1:
            input = torch.softmax(input, 1)
        if self.other_act is not None:
            input = self.other_act(input)
        if self.to_onehot_y and n_pred_ch != 1:
            target = one_hot(target, num_classes=n_pred_ch, dim=1)
        if not self.include_background and n_pred_ch != 1:
            target = target[:, 1:]
            input = input[:, 1:]
        if target.shape != input.shape:
            raise AssertionError(f"ground truth has different shape ({target.shape}) from input ({input.shape})")
        axes = list(range(2, input.ndim))
        if self.batch:
            axes = [0] + axes
        intersection = (target * input).sum(axes)
        if self.squared_pred:
            ground_o, pred_o = (target ** 2).sum(axes), (input ** 2).sum(axes)
        else:
            ground_o, pred_o = target.sum(axes), input.sum(axes)
        denominator = ground_o + pred_o
        if self.jaccard:
            denominator = 2.0 * (denominator - intersection)
        f = 1.0 - (2.0 * intersection + self.smooth_nr) / (denominator + self.smooth_dr)
        if self.weight is not None:
            w = torch.as_tensor(self.weight, dtype=f.dtype, device=f.device)
            if w.ndim == 0:
                w = w.expand(f.shape[-1])
            f = f * w.expand(f.shape)
        return _reduce(f, self.reduction)


class DiceCELoss:
    """Dice plus cross-entropy (binary cross-entropy for one channel or with
    ``sigmoid``), each weighted by its lambda."""

    def __init__(self, include_background: bool = True, to_onehot_y: bool = False, sigmoid: bool = False,
                 softmax: bool = False, other_act: Callable | None = None, squared_pred: bool = False,
                 jaccard: bool = False, reduction: str = "mean", smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 batch: bool = False, ce_weight=None, weight=None, lambda_dice: float = 1.0,
                 lambda_ce: float = 1.0, label_smoothing: float = 0.0):
        self.dice = DiceLoss(include_background=include_background, to_onehot_y=to_onehot_y, sigmoid=sigmoid,
                             softmax=softmax, other_act=other_act, squared_pred=squared_pred, jaccard=jaccard,
                             reduction=reduction, smooth_nr=smooth_nr, smooth_dr=smooth_dr, batch=batch,
                             weight=weight if weight is not None else ce_weight)
        if lambda_dice < 0.0:
            raise ValueError("lambda_dice should be no less than 0.0.")
        if lambda_ce < 0.0:
            raise ValueError("lambda_ce should be no less than 0.0.")
        self.lambda_dice = lambda_dice
        self.lambda_ce = lambda_ce
        self.sigmoid = sigmoid
        self.to_onehot_y = to_onehot_y
        self.label_smoothing = label_smoothing
        self.class_weight = None if ce_weight is None else torch.as_tensor(ce_weight, dtype=torch.float32)

    def ce(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Multi-class cross-entropy on (B, C, *spatial) logits."""
        n_ch = input.shape[1]
        if target.shape == input.shape:
            t = target
        elif target.shape[1] == 1:
            t = one_hot(target, num_classes=n_ch, dim=1)
        else:
            raise ValueError(f"incompatible target shape {target.shape} for input {input.shape}")
        if self.label_smoothing > 0:
            t = t * (1 - self.label_smoothing) + self.label_smoothing / n_ch
        ce_map = -(t * F.log_softmax(input, 1))
        if self.class_weight is not None:
            w = self.class_weight.to(input.device).view(1, n_ch, *(1,) * (input.ndim - 2))
            return (ce_map * w).sum() / (t * w).sum().clamp_min(1e-8)
        return ce_map.sum(1).mean()

    def bce(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return -(target * F.logsigmoid(input) + (1 - target) * F.logsigmoid(-input)).mean()

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if input.shape[1] == 1 or self.sigmoid:
            t = target
            if self.to_onehot_y and input.shape[1] != 1:
                t = one_hot(target, num_classes=input.shape[1], dim=1)
            ce_loss = self.bce(input, t.to(input.dtype))
        else:
            ce_loss = self.ce(input, target)
        return self.lambda_dice * self.dice(input, target) + self.lambda_ce * ce_loss
