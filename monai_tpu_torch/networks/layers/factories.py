"""Layer factories: dimension-parametrized layer construction (counterpart of
monai_tpu/networks/layers/factories.py, for the layers the UNet and SwinUNETR use).

``Conv[Conv.CONV, 3]`` gives a constructor of ``Conv3d``, which sends a 3x3x3
stride-1 SAME convolution to the CUDA kernel (``ops/conv3d.py``); every other
convolution (1x1, the strided patch embedding) and every transposed convolution is
``F.conv3d`` / ``F.conv_transpose3d``, as the JAX package leaves them to XLA.
``Norm``: instance runs the CUDA kernel of ``fast_norm.py``; batch is
``nn.BatchNorm{n}d`` (eps 1e-5, plain PyTorch, as the JAX package has no kernel for
it); layer is ``nn.LayerNorm`` with the JAX package's eps of 1e-6 (torch MONAI uses
1e-5). ``Act``:
the learnable PReLU (init 0.25), LeakyReLU (slope 0.01) and GELU in the tanh
approximation, which is ``jax.nn.gelu``'s default (torch MONAI uses the exact erf).
``Dropout``: torch's dropouts.

Constructors take ``device``, ``dtype`` and a ``torch.Generator``; weights are drawn
from the generator on the generator's device and copied in, so one seed gives the
same weights whatever device the module lives on.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any

import torch
from torch import nn

from ...ops.conv3d import conv3d_3x3_same
from .fast_norm import InstanceNorm

__all__ = ["LayerFactory", "Conv", "ConvTrans", "Norm", "Act", "Dropout", "Conv3d", "split_args",
           "get_act_layer", "get_dropout_layer", "get_norm_layer", "init_uniform_", "linear"]


class LayerFactory:
    """Name → constructor registry with a dimension argument."""

    def __init__(self, name: str):
        self.name = name
        self.factories: dict[str, Callable] = {}

    def factory_function(self, name: str) -> Callable:
        def _add(func: Callable) -> Callable:
            self.factories[name.upper()] = func
            return func

        return _add

    def __getitem__(self, args) -> Any:
        name, *rest = (args,) if isinstance(args, str) else args
        return self.factories[str(name).upper()](*rest)

    def __getattr__(self, key: str) -> str:
        if key.upper() in self.factories:
            return key.upper()
        raise AttributeError(f"{self.name} has no factory {key}")


def split_args(args):
    """Split a ``"name"`` or ``("name", {kwargs})`` layer spec."""
    if isinstance(args, str):
        return args, {}
    name_obj, name_args = args
    if not isinstance(name_obj, str) or not isinstance(name_args, dict):
        raise TypeError("Layer specifiers must be single strings or pairs of the form (name, argument dict)")
    return name_obj, name_args


Conv = LayerFactory("Conv")
ConvTrans = LayerFactory("ConvTrans")
Norm = LayerFactory("Norm")
Act = LayerFactory("Act")
Dropout = LayerFactory("Dropout")


@torch.no_grad()
def init_uniform_(layer: nn.Module, generator: torch.Generator | None) -> nn.Module:
    """torch's default conv and linear init, U(±1/sqrt(fan_in)) for weight and bias,
    drawn from ``generator``; with no generator torch's own init stands."""
    if generator is None:
        return layer
    w = layer.weight
    bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
    for p in (w, layer.bias):
        if p is not None:
            vals = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
            p.copy_(vals.uniform_(-bound, bound, generator=generator))
    return layer


def linear(in_features: int, out_features: int, bias: bool = True, device=None, dtype=None,
           generator: torch.Generator | None = None) -> nn.Linear:
    """``nn.Linear`` with its weights drawn from ``generator``."""
    return init_uniform_(nn.Linear(in_features, out_features, bias=bias, device=device, dtype=dtype), generator)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose 3x3x3, stride-1, dilation-1, ungrouped, zero-padded SAME case
    runs ``ops.conv3d.conv3d_3x3_same`` on the channels-last view of its input."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.same_3x3x3 = (self.kernel_size == (3, 3, 3) and self.stride == (1, 1, 1)
                           and self.dilation == (1, 1, 1) and self.groups == 1
                           and self.padding in ((1, 1, 1), "same") and self.padding_mode == "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.same_3x3x3:
            return super().forward(x)
        w = self.weight.permute(2, 3, 4, 1, 0).contiguous()  # (O,I,kd,kh,kw) -> (kd,kh,kw,I,O)
        y = conv3d_3x3_same(x.permute(0, 2, 3, 4, 1).contiguous(), w, self.bias)
        return y.permute(0, 4, 1, 2, 3)  # channel-first view, channels-last memory


_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: Conv3d}
_CONVTRANS = {1: nn.ConvTranspose1d, 2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_DROPOUT = {1: nn.Dropout, 2: nn.Dropout2d, 3: nn.Dropout3d}
_BATCHNORM = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


@Conv.factory_function("conv")
def conv_factory(dim: int):
    def make(in_channels, out_channels, kernel_size=3, stride=1, padding=0, dilation=1, groups=1,
             bias=True, device=None, dtype=None, generator=None):
        return init_uniform_(_CONV[dim](in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                                        dilation=dilation, groups=groups, bias=bias, device=device,
                                        dtype=dtype), generator)

    return make


@Conv.factory_function("convtrans")
@ConvTrans.factory_function("convtrans")
def convtrans_factory(dim: int):
    def make(in_channels, out_channels, kernel_size=3, stride=1, padding=0, output_padding=0, groups=1,
             bias=True, dilation=1, device=None, dtype=None, generator=None):
        return init_uniform_(_CONVTRANS[dim](in_channels, out_channels, kernel_size, stride=stride,
                                             padding=padding, output_padding=output_padding, groups=groups,
                                             bias=bias, dilation=dilation, device=device, dtype=dtype),
                             generator)

    return make


@Norm.factory_function("instance")
def instance_factory(dim: int):
    # affine defaults to False, as torch's InstanceNorm{n}d and the JAX package's factory
    def make(num_features, affine: bool = False, eps: float = 1e-5, device=None, dtype=None):
        return InstanceNorm(num_features, eps=eps, affine=affine, device=device, dtype=dtype)

    return make


@Norm.factory_function("batch")
def batch_factory(dim: int):
    # eps 1e-5 as the JAX package's nnx.BatchNorm (torch's momentum 0.1 is nnx's 0.9)
    def make(num_features, eps: float = 1e-5, device=None, dtype=None):
        return _BATCHNORM[dim](num_features, eps=eps, device=device, dtype=dtype)

    return make


@Norm.factory_function("layer")
def layer_factory(dim: int):
    def make(num_features, eps: float = 1e-6, elementwise_affine: bool = True, device=None, dtype=None):
        return nn.LayerNorm(num_features, eps=eps, elementwise_affine=elementwise_affine, device=device,
                            dtype=dtype)

    return make


@Act.factory_function("prelu")
def prelu_factory(dim: int = 1):
    def make(num_parameters: int = 1, init: float = 0.25, device=None, dtype=None):
        return nn.PReLU(num_parameters, init, device=device, dtype=dtype)

    return make


@Act.factory_function("leakyrelu")
def leakyrelu_factory(dim: int = 1):
    def make(negative_slope: float = 0.01, inplace: bool = False, device=None, dtype=None):
        return nn.LeakyReLU(negative_slope, inplace=inplace)

    return make


@Act.factory_function("gelu")
def gelu_factory(dim: int = 1):
    def make(approximate: str = "tanh", device=None, dtype=None):
        return nn.GELU(approximate=approximate)

    return make


@Dropout.factory_function("dropout")
def dropout_factory(dim: int):
    def make(p: float = 0.5):
        return _DROPOUT[dim](p)

    return make


def get_norm_layer(name, spatial_dims: int = 1, channels: int | None = None, device=None, dtype=None):
    """A norm layer from a spec such as ``"INSTANCE"`` or ``("instance", {"affine": True})``."""
    norm_name, norm_args = split_args(name)
    kw = dict(norm_args)
    if channels is not None:
        kw.setdefault("num_features", channels)
    return Norm[norm_name, spatial_dims](device=device, dtype=dtype, **kw)


def get_act_layer(name, device=None, dtype=None):
    """An activation layer from a spec such as ``"PRELU"``."""
    act_name, act_args = split_args(name)
    return Act[act_name, 1](device=device, dtype=dtype, **act_args)


def get_dropout_layer(name, dropout_dim: int = 1):
    """A dropout layer from a probability or a spec such as ``("dropout", {"p": 0.1})``."""
    if isinstance(name, (int, float)):
        return Dropout["dropout", dropout_dim](p=float(name))
    drop_name, drop_args = split_args(name)
    return Dropout[drop_name, dropout_dim](**drop_args)
