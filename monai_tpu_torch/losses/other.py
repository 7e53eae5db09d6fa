"""CrossEntropyLoss (counterpart of the class in monai_tpu/losses/other.py), the
classification bundle's loss: softmax cross-entropy over the class axis 1 of logits
(B, K, *spatial), on integer targets (B, *spatial) or (B, 1, *spatial), or one-hot
(or soft) targets (B, K, *spatial)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss:
    """``label_smoothing`` mixes the one-hot target with the uniform 1/K; a class
    ``weight`` scales each class's term, and the "mean" reduction then divides by the sum of
    the weighted (smoothed) targets, at least 1e-8. This is the JAX package's math: where
    smoothing and weights meet, ``F.cross_entropy`` divides by the weights of the target
    classes alone, so the two differ there."""

    def __init__(self, weight=None, reduction: str = "mean", label_smoothing: float = 0.0):
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.reduction = reduction
        self.label_smoothing = float(label_smoothing)

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        n_cls = input.shape[1]
        logp = torch.log_softmax(input, dim=1)
        if target.ndim == input.ndim - 1 or (target.ndim == input.ndim and target.shape[1] == 1):
            tgt = target[:, 0] if target.ndim == input.ndim else target
            onehot = F.one_hot(tgt.long(), n_cls).movedim(-1, 1).to(logp.dtype)
        else:
            onehot = target.to(logp.dtype)
        if self.label_smoothing > 0:
            onehot = onehot * (1 - self.label_smoothing) + self.label_smoothing / n_cls
        nll = -(onehot * logp)
        if self.weight is not None:
            w = self.weight.to(device=logp.device, dtype=logp.dtype).reshape([1, n_cls] + [1] * (input.ndim - 2))
            nll = nll * w
        loss = nll.sum(dim=1)
        if self.reduction == "mean":
            if self.weight is not None:
                return loss.sum() / (onehot * w).sum().clamp_min(1e-8)
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss
