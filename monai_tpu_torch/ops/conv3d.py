"""3x3x3 stride-1 SAME 3-D convolution, channels-last (NDHWC x DHWIO), on a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_conv3d.py::conv3d_3x3_same. The kernel is
``csrc/conv3d_3x3_same.cu`` (implicit GEMM; its header says what bounds it on the card
and what the design does about that). ``conv3d_3x3_same_plain`` is the same function in
plain PyTorch: the wrapper runs it for tensors on the CPU, and it is the oracle the
kernel is held to on the card. For a CUDA tensor the wrapper launches the kernel or
raises; it never falls back. Forward only: the slice is inference.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import library

__all__ = ["conv3d_3x3_same", "conv3d_3x3_same_plain"]

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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("conv3d_3x3_same is forward-only; run it under torch.inference_mode()")


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
    ``conv3d_3x3_same.launches``."""
    _check(x, w, bias)
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
    conv3d_3x3_same.launches += 1
    return y


conv3d_3x3_same.launches = 0
