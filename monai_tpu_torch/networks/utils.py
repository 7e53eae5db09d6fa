"""Network helpers (counterpart of monai_tpu/networks/utils.py, for the training step):
``one_hot``, ``pixelshuffle`` and ``pixelunshuffle``, ``generator_on`` for a module's random
draws on its tensors' device, and the mixed-precision view of a model,
``cast_params_to_compute`` and ``amp_model_view``.

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

__all__ = ["amp_model_view", "cast_params_to_compute", "generator_on", "one_hot", "pixelshuffle",
           "pixelunshuffle"]


def one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype = torch.float32, dim: int = 1) -> torch.Tensor:
    """One-hot encode along ``dim``, which must have size 1 (labels of lower rank gain
    trailing singleton dims first)."""
    if labels.ndim < dim + 1:
        labels = labels.reshape(*labels.shape, *(1,) * (dim + 1 - labels.ndim))
    if labels.shape[dim] != 1:
        raise AssertionError("labels should have a channel with length equal to one.")
    idx = labels.long().squeeze(dim)
    return torch.movedim(nn.functional.one_hot(idx, num_classes).to(dtype), -1, dim)


def pixelshuffle(x: torch.Tensor, spatial_dims: int, scale_factor: int) -> torch.Tensor:
    """Depth to space on a channel-first (B, C f^d, *S) tensor: (B, C, *(S f)), output
    channel c and offsets (r_1, ..., r_d) read input channel c f^d + (r_1 f + r_2) f + ...,
    torch MONAI's order (what the JAX function computes)."""
    b, channels, *spatial = x.shape
    f, d = scale_factor, spatial_dims
    if channels % f**d:
        raise ValueError(f"Number of input channels ({channels}) must be evenly divisible by scale_factor ** "
                         f"dimensions ({f}**{d}={f**d}).")
    c = channels // f**d
    x = x.reshape(b, c, *(f,) * d, *spatial)
    x = x.permute(0, 1, *(i for k in range(d) for i in (2 + d + k, 2 + k)))  # (b, c, s_1, r_1, s_2, r_2, ...)
    return x.reshape(b, c, *(s * f for s in spatial))


def pixelunshuffle(x: torch.Tensor, spatial_dims: int, scale_factor: int) -> torch.Tensor:
    """Space to depth, the inverse of ``pixelshuffle``: (B, C, *(S f)) to (B, C f^d, *S)."""
    b, c, *spatial = x.shape
    f, d = scale_factor, spatial_dims
    if any(s % f for s in spatial):
        raise ValueError(f"spatial shape {tuple(spatial)} not divisible by {f}.")
    x = x.reshape(b, c, *(n for s in spatial for n in (s // f, f)))  # (b, c, s_1, r_1, s_2, r_2, ...)
    x = x.permute(0, 1, *(3 + 2 * k for k in range(d)), *(2 + 2 * k for k in range(d)))
    return x.reshape(b, c * f**d, *(s // f for s in spatial))


def generator_on(generator: torch.Generator | None, device: torch.device,
                 made: dict) -> torch.Generator | None:
    """The generator that draws on ``device``: ``generator`` where it lies there, torch's
    default one of ``device`` where it is None, else a generator on ``device`` seeded once
    from ``generator`` and kept in ``made`` (a dict of the module's own). A net is built on
    the CPU from a seeded generator; this keeps its draws seeded and on the card when its
    tensors are there."""
    if generator is None or generator.device == device:
        return generator
    key = (id(generator), str(device))
    if key not in made:
        seed = int(torch.randint(2**62, (), generator=generator))
        made[key] = torch.Generator(device=device).manual_seed(seed)
    return made[key]


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
