"""CrossEntropyLoss and DeepSupervisionLoss (counterparts of the classes in
monai_tpu/losses/other.py). CrossEntropyLoss is the classification bundle's loss: softmax
cross-entropy over the class axis 1 of logits (B, K, *spatial), on integer targets
(B, *spatial) or (B, 1, *spatial), or one-hot (or soft) targets (B, K, *spatial).
DeepSupervisionLoss weighs a loss over DynUNet's deep-supervision heads."""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F

__all__ = ["CrossEntropyLoss", "DeepSupervisionLoss"]


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


class DeepSupervisionLoss:
    """``loss`` over a list of outputs, the first at full size, summed with a weight a
    level: ``weights`` where it has as many as the levels, else by ``weight_mode``
    ("same": 1 each; "exp": 0.5 ** level, at least 0.0625; "two": 1 then 0.5). A target
    of another spatial size than an output is resized to it by nearest neighbours
    (``F.interpolate``'s "nearest-exact", the index ``jax.image.resize`` picks). One
    tensor is the plain ``loss``. The outputs are cast to float32 first."""

    def __init__(self, loss, weight_mode: str = "exp", weights: Sequence[float] | None = None):
        self.loss = loss
        self.weight_mode = weight_mode
        self.weights = weights

    def get_weights(self, levels: int = 1) -> list[float]:
        levels = max(1, levels)
        if self.weights is not None and len(self.weights) >= levels:
            return list(self.weights[:levels])
        if self.weight_mode == "exp":
            return [max(0.5**level, 0.0625) for level in range(levels)]
        if self.weight_mode == "two":
            return [1.0 if level == 0 else 0.5 for level in range(levels)]
        return [1.0] * levels

    def get_loss(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if input.shape[2:] != target.shape[2:]:
            target = F.interpolate(target.float(), size=input.shape[2:], mode="nearest-exact").to(target.dtype)
        return self.loss(input, target)

    def __call__(self, input, target: torch.Tensor) -> torch.Tensor:
        if isinstance(input, (list, tuple)):
            loss = 0.0
            for level, w in enumerate(self.get_weights(levels=len(input))):
                loss = loss + w * self.get_loss(input[level].float(), target)
            return loss
        return self.loss(input.float(), target)
