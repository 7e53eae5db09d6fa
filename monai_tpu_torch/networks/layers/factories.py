"""Layer factories: dimension-parametrized layer construction (counterpart of
monai_tpu/networks/layers/factories.py, for the layers the UNet and SwinUNETR use).

``Conv[Conv.CONV, 3]`` gives a constructor of ``Conv3d``, which sends a 3x3x3
stride-1 SAME convolution to the CUDA kernel (``ops/conv3d.py``); every other
convolution (1x1, the strided patch embedding) and every transposed convolution is
``F.conv3d`` / ``F.conv_transpose3d``, as the JAX package leaves them to XLA. Those
run in full float32 on float32 CUDA inputs whatever torch's TF32 setting
(``full_float32``), forward and backward (``_Float32Conv``): torch's default lets cuDNN
round their float32 inputs to TF32's 10-bit mantissa, and the port's float32 path is held
to the CPU's float32. (torch's float32 matrix products, the ``Linear`` layers, run in
full float32 by default: ``torch.backends.cuda.matmul.allow_tf32`` is False.)
``Norm``: instance runs the CUDA kernel of ``fast_norm.py``; batch is
``nn.BatchNorm{n}d`` (eps 1e-5, plain PyTorch, as the JAX package has no kernel for
it) whose train mode adds the biased batch variance to ``running_var``, as
``nnx.BatchNorm`` does (torch adds the unbiased one); layer is ``nn.LayerNorm`` with the
JAX package's eps of 1e-6 (torch MONAI uses 1e-5); group is ``nn.GroupNorm`` (eps 1e-5,
affine; a CPU input in channel-first memory, ``GroupNorm``), its group count clamped down to the largest divisor of the channels, as the JAX
factory does (``nnx.GroupNorm`` is a library op there too, no kernel). ``Act``:
the learnable PReLU (init 0.25), ReLU, LeakyReLU (slope 0.01) and GELU in the tanh
approximation, which is ``jax.nn.gelu``'s default (torch MONAI uses the exact erf).
``Dropout``: torch's dropouts (``dropout_dim`` 1 drops elements, 2 and 3 whole channels).
``Pool``: torch's max, average and adaptive pools at 1 to 3 dimensions (a max pool pads
with -inf and an average pool counts its zero padding, as ``nnx.max_pool`` and
``nnx.avg_pool`` do).

Mixed types follow the JAX package's default conv path (what its ``SupervisedEvaluator(amp=True)``
runs: a bfloat16 input into float32 weights). A 3x3x3 stride-1 SAME conv casts its kernel to the
input's type where min(CI, 128) >= 2 min(CO, 128) (``PallasConv``'s swapped weight-grad path casts
there) and runs in that type; every other conv, transposed or not, promotes its input and kernel to
their common type (``nnx.Conv`` and ``nnx.ConvTranspose``), so a bfloat16 input meets float32
weights in float32 (``kernel_takes_input_type``, ``_promoted``).

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
from torch.autograd.function import once_differentiable

from ...ops.conv3d import conv3d_3x3_same
from ...utils.backend import full_float32
from .fast_norm import InstanceNorm

__all__ = ["LayerFactory", "Conv", "ConvTrans", "Norm", "Act", "Dropout", "Pool", "Conv3d", "ConvTranspose3d",
           "GroupNorm", "split_args", "get_act_layer", "get_dropout_layer", "get_norm_layer", "get_pool_layer", "init_uniform_",
           "kernel_takes_input_type", "linear"]


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
Pool = LayerFactory("Pool")


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


_conv_backward = torch.ops.aten.convolution_backward  # a name of this module, which a test can watch


class _Float32Conv(torch.autograd.Function):
    """A cuDNN convolution (``aten.convolution``) whose forward and backward each run in
    ``full_float32``: autograd would run the backward later, under the caller's TF32
    setting."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, transposed, output_padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, transposed, output_padding, groups)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        with full_float32(x):
            return torch.ops.aten.convolution(x, weight, bias, stride, padding, dilation, transposed, output_padding,
                                              groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.needs_input_grad[2] and ctx.bias_sizes is not None]
        with full_float32(x):
            dx, dw, db = _conv_backward(g.contiguous(), x, weight, ctx.bias_sizes, *ctx.conf, mask)
        return dx, dw, db, None, None, None, None, None, None


def kernel_takes_input_type(in_channels: int, out_channels: int) -> bool:
    """Whether a 3x3x3 stride-1 SAME conv of an input of another type than its weights
    casts its kernel to the input's type, as the JAX package's default path does
    (``PallasConv``: its swapped weight-grad orientation, taken where min(CI, 128) >=
    2 min(CO, 128), casts the kernel; ``nnx.Conv`` elsewhere promotes both)."""
    return min(in_channels, 128) >= 2 * min(out_channels, 128)


def _promoted(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` in the weights' type where that is the wider of the two (``nnx.Conv``'s
    promotion of a bfloat16 input into float32 weights); as it is otherwise."""
    if x.dtype != weight.dtype and torch.promote_types(x.dtype, weight.dtype) == weight.dtype:
        return x.to(weight.dtype)
    return x


def _exact_float32(base: type) -> type:
    """``base``, a torch convolution module, with its calls in ``full_float32``: on a
    float32 CUDA input with numeric zero padding, forward and backward (``_Float32Conv``);
    otherwise the module's own call inside ``full_float32`` (TF32 does not touch the
    other types). A narrower input than the weights is promoted to their type
    (``_promoted``)."""

    class Exact(base):
        def forward(self, x: torch.Tensor, *args) -> torch.Tensor:
            x = _promoted(x, self.weight)
            if (x.device.type == "cuda" and x.dtype == torch.float32 and self.padding_mode == "zeros"
                    and not isinstance(self.padding, str) and not args):
                transposed = isinstance(self, nn.modules.conv._ConvTransposeNd)
                out_pad = tuple(self.output_padding) if transposed else (0,) * len(self.stride)
                return _Float32Conv.apply(x, self.weight, self.bias, list(self.stride), list(self.padding),
                                          list(self.dilation), transposed, list(out_pad), self.groups)
            with full_float32(x):
                return super().forward(x, *args)

    Exact.__name__ = Exact.__qualname__ = base.__name__
    Exact.__doc__ = (f"``nn.{base.__name__}`` in full float32 on float32 CUDA inputs (``full_float32``), a narrower "
                     f"input promoted to the weights' type.")
    return Exact


ConvTranspose3d = _exact_float32(nn.ConvTranspose3d)


class Conv3d(_exact_float32(nn.Conv3d)):
    """``nn.Conv3d`` whose 3x3x3, stride-1, dilation-1, ungrouped, zero-padded SAME case
    runs ``ops.conv3d.conv3d_3x3_same`` on the channels-last view of its input; any other
    runs cuDNN, in full float32 on float32 CUDA inputs (``full_float32``). A bfloat16 input
    into float32 weights runs the SAME case in bfloat16 where ``kernel_takes_input_type``
    says so, else in float32."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.same_3x3x3 = (self.kernel_size == (3, 3, 3) and self.stride == (1, 1, 1)
                           and self.dilation == (1, 1, 1) and self.groups == 1
                           and self.padding in ((1, 1, 1), "same") and self.padding_mode == "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.same_3x3x3:
            return super().forward(x)
        w, b = self.weight, self.bias
        if x.dtype != w.dtype and kernel_takes_input_type(self.in_channels, self.out_channels):
            w, b = w.to(x.dtype), None if b is None else b.to(x.dtype)
        else:
            x = _promoted(x, w)
        w = w.permute(2, 3, 4, 1, 0).contiguous()  # (O,I,kd,kh,kw) -> (kd,kh,kw,I,O)
        y = conv3d_3x3_same(x.permute(0, 2, 3, 4, 1).contiguous(), w, b)
        return y.permute(0, 4, 1, 2, 3)  # channel-first view, channels-last memory


_CONV = {1: _exact_float32(nn.Conv1d), 2: _exact_float32(nn.Conv2d), 3: Conv3d}
_CONVTRANS = {1: _exact_float32(nn.ConvTranspose1d), 2: _exact_float32(nn.ConvTranspose2d), 3: ConvTranspose3d}
_DROPOUT = {1: nn.Dropout, 2: nn.Dropout2d, 3: nn.Dropout3d}


def _biased_batch_norm(base: type) -> type:
    """``base``, a torch batch norm, whose train mode folds the biased batch variance into
    ``running_var``, as the JAX package's ``nnx.BatchNorm`` does (torch folds the unbiased
    one, n/(n−1) times it). The normalisation, the momentum, ``eps`` and the state names
    are torch's; eval mode, and a norm that keeps no running statistics, is torch's call as
    it stands."""

    class Biased(base):
        def forward(self, x: torch.Tensor) -> torch.Tensor:
            if not (self.training and self.track_running_stats):
                return super().forward(x)
            old = self.running_var.detach().clone()
            y = super().forward(x)
            # torch added factor * var * n/(n-1) to (1 - factor) * old; take the n/(n-1) out. The
            # op saved running_var for its backward (which train mode does not read), so the
            # update goes through .data, past autograd's version check.
            n = x.numel() // x.shape[1]
            factor = 1.0 / float(self.num_batches_tracked) if self.momentum is None else self.momentum
            kept = old.mul_(1.0 - factor)
            self.running_var.data.sub_(kept).mul_((n - 1) / n).add_(kept)
            return y

    Biased.__name__ = Biased.__qualname__ = base.__name__
    Biased.__doc__ = (f"``nn.{base.__name__}`` whose train mode adds the biased batch variance to "
                      f"``running_var``, as ``nnx.BatchNorm`` does.")
    return Biased


_BATCHNORM = {n: _biased_batch_norm(cls) for n, cls in ((1, nn.BatchNorm1d), (2, nn.BatchNorm2d), (3, nn.BatchNorm3d))}


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


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` that gives a CPU input to torch in channel-first memory: torch's CPU
    kernel sums channels-last memory in one float32 pass of x and x^2, and loses a group
    whose variance is small against its mean (4.2 std of the output off the float64 math
    at a group of 98% one value, where channel-first memory is within 1e-5), as kernel 1's
    channels-last outputs give it in a window of background. The card's kernel is as
    accurate either way and takes the input as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.contiguous() if x.device.type == "cpu" else x)


@Norm.factory_function("group")
def group_factory(dim: int):
    # num_channels is torch's name for the channels, num_features the factory's
    def make(num_features: int | None = None, num_groups: int = 8, num_channels: int | None = None,
             eps: float = 1e-5, affine: bool = True, device=None, dtype=None):
        channels = num_channels if num_channels is not None else num_features
        groups = num_groups
        while channels % groups:  # the largest divisor of the channels at most num_groups
            groups -= 1
        return GroupNorm(groups, channels, eps=eps, affine=affine, device=device, dtype=dtype)

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


@Act.factory_function("relu")
def relu_factory(dim: int = 1):
    def make(inplace: bool = False, device=None, dtype=None):
        return nn.ReLU(inplace=inplace)

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


_POOLS = {"max": (nn.MaxPool1d, nn.MaxPool2d, nn.MaxPool3d), "avg": (nn.AvgPool1d, nn.AvgPool2d, nn.AvgPool3d),
          "adaptivemax": (nn.AdaptiveMaxPool1d, nn.AdaptiveMaxPool2d, nn.AdaptiveMaxPool3d),
          "adaptiveavg": (nn.AdaptiveAvgPool1d, nn.AdaptiveAvgPool2d, nn.AdaptiveAvgPool3d)}


def _pool_factory(kind: str):
    def factory(dim: int):
        cls = _POOLS[kind][dim - 1]

        def make(*args, device=None, dtype=None, **kwargs):
            return cls(*args, **kwargs)

        return make

    return factory


for _kind in _POOLS:
    Pool.factory_function(_kind)(_pool_factory(_kind))


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


def get_pool_layer(name, spatial_dims: int = 1):
    """A pool layer from a spec such as ``("max", {"kernel_size": 2})``."""
    pool_name, pool_args = split_args(name)
    return Pool[pool_name, spatial_dims](**pool_args)


def get_dropout_layer(name, dropout_dim: int = 1):
    """A dropout layer from a probability or a spec such as ``("dropout", {"p": 0.1})``."""
    if isinstance(name, (int, float)):
        return Dropout["dropout", dropout_dim](p=float(name))
    drop_name, drop_args = split_args(name)
    return Dropout[drop_name, dropout_dim](**drop_args)
