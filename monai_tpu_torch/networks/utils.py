"""Network helpers (counterpart of monai_tpu/networks/utils.py, for the training step):
``one_hot``, and the mixed-precision view of a model, ``cast_params_to_compute`` and
``amp_model_view``.

Mixed precision as the JAX package has it: the float32 master parameters stay with the
optimizer, and the step runs the model on a bfloat16 copy of them that is part of the
autograd graph, so every layer computes in bfloat16 (the 3x3x3 conv and norm kernels,
cuDNN's strided and transposed convs) and the grads arrive in float32 on the masters
through the casts. Casting only the input is not enough: an input that meets a float32
weight runs that layer in float32.
"""
from __future__ import annotations

from collections.abc import Callable, Mapping

import torch
from torch import nn

__all__ = ["amp_model_view", "cast_params_to_compute", "one_hot"]


def one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype = torch.float32, dim: int = 1) -> torch.Tensor:
    """One-hot encode along ``dim``, which must have size 1 (labels of lower rank gain
    trailing singleton dims first)."""
    if labels.ndim < dim + 1:
        labels = labels.reshape(*labels.shape, *(1,) * (dim + 1 - labels.ndim))
    if labels.shape[dim] != 1:
        raise AssertionError("labels should have a channel with length equal to one.")
    idx = labels.long().squeeze(dim)
    return torch.movedim(nn.functional.one_hot(idx, num_classes).to(dtype), -1, dim)


def cast_params_to_compute(params: Mapping[str, torch.Tensor],
                           dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Every floating-point tensor of ``params`` cast to ``dtype`` (a differentiable cast,
    so grads flow back to the originals in their own type); others as they are."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


def amp_model_view(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> Callable[..., torch.Tensor]:
    """The model as a callable that runs on a ``dtype`` copy of its parameters and of its
    buffers (``torch.func.functional_call``), as the JAX package's view casts every
    floating leaf of the model's state. A batch norm in train mode so updates the view's
    copies of its running statistics and leaves the model's own as they were, as the JAX
    amp step does (its view's statistics are not merged back): under amp the model learns no
    running statistics, a fault of the reference kept for parity (ROADMAP C13). Make the view inside the
    step, so its casts are in the graph."""
    view = cast_params_to_compute(dict(model.named_parameters()), dtype)
    view.update({k: v.to(dtype) if v.is_floating_point() else v.clone() for k, v in model.named_buffers()})

    def run(*args, **kwargs):
        return torch.func.functional_call(model, view, args, kwargs, strict=False)

    return run
