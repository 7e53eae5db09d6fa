"""3x3x3 stride-1 SAME 3-D convolution, channels-last (NDHWC x DHWIO), on a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_conv3d.py::conv3d_3x3_same. The kernel is
``csrc/conv3d_3x3_same.cu`` (implicit GEMM; its header says what bounds it on the card
and what the design does about that). ``conv3d_3x3_same_plain`` is the same function in
plain PyTorch: the wrapper runs it for tensors on the CPU, and it is the oracle the
kernel is held to on the card. For a CUDA tensor the wrapper launches the kernel or
raises; it never falls back.

Under autograd the wrapper is the counterpart of the JAX custom VJP
(``conv3d_3x3_same`` with ``_conv3d_fwd_rule`` and ``_conv3d_bwd_rule``): dx is the same
kernel on g and the flipped, transposed weights; dw is the kernel of
``csrc/conv3d_3x3_wgrad.cu`` (``conv3d_3x3_wgrad``, its plain version
``conv3d_3x3_wgrad_plain``: 27 shifted-slice products summed in float32); the bias grad is
the float32 sum of g. dx and dw come out in the types of x and w.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
import torch.nn.functional as F

from ._build import library
from ..utils.counters import count_launch

__all__ = ["conv3d_3x3_same", "conv3d_3x3_same_plain", "conv3d_3x3_wgrad", "conv3d_3x3_wgrad_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def conv3d_3x3_same_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-PyTorch version: ``F.conv3d`` on the channel-first views."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), bias, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> None:
    if x.ndim != 5 or w.ndim != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d_3x3_same takes x (N,D,H,W,CI) and w (3,3,3,CI,CO); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"conv3d_3x3_same takes float32, bfloat16 or float16 x and w of one dtype; got "
                        f"{x.dtype} and {w.dtype}")
    if bias is not None and (tuple(bias.shape) != (w.shape[4],) or bias.dtype != x.dtype):
        raise ValueError(f"bias must be ({w.shape[4]},) {x.dtype}; got {tuple(bias.shape)} {bias.dtype}")
    tensors = (x, w) if bias is None else (x, w, bias)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w and bias must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3d_3x3_same takes contiguous tensors")


@functools.cache
def _launcher():
    fn = library().monai_conv3d_3x3_same
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3d_3x3_same(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """3D conv, kernel 3^3, stride 1, SAME zero padding; channels-last x (N,D,H,W,CI),
    w (3,3,3,CI,CO), optional bias (CO,) -> (N,D,H,W,CO) in x's dtype.

    CPU tensors run the plain version; CUDA tensors run the CUDA kernel and add one to
    ``conv3d_3x3_same.launches``. Under autograd the backward runs the kernel again for dx
    (one more launch) and ``conv3d_3x3_wgrad`` for dw."""
    _check(x, w, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        return _Conv3x3Same.apply(x, w, bias)
    return _forward(x, w, bias)


def _forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3d_3x3_same_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_3x3_same runs on CPU or CUDA tensors, not {x.device}")
    n, d, h, ww, ci = x.shape
    co = w.shape[4]
    y = torch.empty((n, d, h, ww, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
                          y.data_ptr(), n, d, h, ww, ci, co, _DTYPE_CODES[x.dtype],
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_3x3_same: CUDA launch failed with error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, CO {co})")
    count_launch(conv3d_3x3_same)
    return y


conv3d_3x3_same.launches = 0


class _Conv3x3Same(torch.autograd.Function):
    """The JAX rule: dx = conv(g, w flipped over the taps, CI and CO swapped); dw the
    correlation of x with g; db = sum(g) in float32."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return _forward(x, w, bias)

    copied_bytes = 0  # grads that came back in another layout and were copied, in bytes

    @staticmethod
    @once_differentiable  # the backward kernels have no backward of their own
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if not g.is_contiguous():  # the consumer's grad came back channel-first
            _Conv3x3Same.copied_bytes += g.numel() * g.element_size()
            g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _forward(g, w.flip((0, 1, 2)).transpose(3, 4).contiguous(), None)
        if ctx.needs_input_grad[1]:
            dw = conv3d_3x3_wgrad(x, g)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2, 3), dtype=torch.float32).to(w.dtype)
        return dx, dw, db


def conv3d_3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of ``conv3d_3x3_wgrad``: for each of the 27 taps, the
    product of x shifted by the tap (zero-padded) with g over all voxels, in float32."""
    n, d, h, w, ci = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.float().reshape(-1, g.shape[-1])
    taps = [xp[:, kd:kd + d, kh:kh + h, kw:kw + w].reshape(-1, ci).T @ gf
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, ci, g.shape[-1]).to(x.dtype)


@functools.cache
def _wgrad_fns():
    lib = library()
    plan, run = lib.monai_conv3d_3x3_wgrad_plan, lib.monai_conv3d_3x3_wgrad
    plan.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    return plan, run


@functools.lru_cache(maxsize=256)
def _wgrad_plan(index: int, shape: tuple[int, ...], co: int, dtype: torch.dtype, aligned: bool) -> tuple[int, ...]:
    """(route: 0 tensor cores, 1 FMA; K chunks; float32 partials; blocks; threads) of the
    kernel's launch on card ``index``."""
    out = (ctypes.c_longlong * 5)()
    with torch.cuda.device(index):
        err = _wgrad_fns()[0](*shape, co, _DTYPE_CODES[dtype], int(aligned), out)
    if err != 0:
        raise RuntimeError(f"conv3d_3x3_wgrad: no plan for x {shape} CO {co} {dtype} (CUDA error {err})")
    return tuple(out)


def conv3d_3x3_wgrad_plan(x: torch.Tensor, g: torch.Tensor) -> dict:
    """What ``conv3d_3x3_wgrad`` launches for CUDA tensors x and g, without launching it:
    ``route`` ("mma" on the tensor cores or "fma"), ``chunks`` of K, the float32
    ``partial`` values of its first launch, its ``blocks`` and ``threads``."""
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    route, chunks, partial, blocks, threads = _wgrad_plan(x.device.index, tuple(x.shape), g.shape[-1], x.dtype,
                                                          aligned)
    return {"route": ("mma", "fma")[route], "chunks": chunks, "partial": partial, "blocks": blocks,
            "threads": threads}


def conv3d_3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``conv3d_3x3_same``: x (N,D,H,W,CI) and g (N,D,H,W,CO),
    contiguous, of one type -> dw (3,3,3,CI,CO) in that type, summed in float32.

    CPU tensors run the plain version; CUDA tensors run the kernel (two launches: the
    chunks' partial sums, then their sum in a fixed order) and add one to
    ``conv3d_3x3_wgrad.launches``."""
    if x.ndim != 5 or g.ndim != 5 or x.shape[:4] != g.shape[:4]:
        raise ValueError(f"conv3d_3x3_wgrad takes x (N,D,H,W,CI) and g (N,D,H,W,CO); got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"conv3d_3x3_wgrad takes float32, bfloat16 or float16 x and g of one dtype; got {x.dtype} "
                        f"and {g.dtype}")
    if x.device != g.device or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("conv3d_3x3_wgrad takes contiguous x and g on one device")
    if x.device.type == "cpu":
        return conv3d_3x3_wgrad_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_3x3_wgrad runs on CPU or CUDA tensors, not {x.device}")
    ci, co = x.shape[4], g.shape[4]
    dw = torch.empty((3, 3, 3, ci, co), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    plan = conv3d_3x3_wgrad_plan(x, g)
    partial = torch.empty(plan["partial"], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _wgrad_fns()[1](x.data_ptr(), g.data_ptr(), dw.data_ptr(), partial.data_ptr(), *x.shape, co,
                              _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_3x3_wgrad: CUDA launch failed with error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, CO {co}, plan {plan})")
    count_launch(conv3d_3x3_wgrad)
    return dw


conv3d_3x3_wgrad.launches = 0
