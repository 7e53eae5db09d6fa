"""Fused windowed attention, softmax(q kᵀ + bias + mask) v, on a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_window_attention.py::fused_window_attention. The
kernel is ``csrc/window_attention.cu`` (its header says what bounds it on the card and
what the design does about that). ``fused_window_attention_plain`` is the same function
in plain PyTorch, and not the XLA formulation: the scores and the softmax are float32,
the normalised probabilities are rounded to the input type, and p·v accumulates in
float32, as the TPU kernel does. The wrapper runs it for tensors on the CPU, and it is
the oracle the kernel is held to on the card. For a CUDA tensor the wrapper launches the
kernel or raises; it never falls back. Forward only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import library
from ..utils.counters import count_launch

__all__ = ["fused_window_attention", "fused_window_attention_plain", "window_attention_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INSTANCES = ("mma", "fma", "generic")


def fused_window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-PyTorch version: float32 scores and softmax, p rounded to q's dtype, p·v in
    float32, output in q's dtype."""
    b, h, n, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s += bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s.view(b // nw, nw, h, n, n).add_(mask.float()[None, :, None])
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _check(q, k, v, bias, mask) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_window_attention takes q, k, v of one shape (B, H, N, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, _ = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_window_attention takes float32, bfloat16 or float16 q, k, v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(bias.shape) != (h, n, n) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be ({h}, {n}, {n}) float32; got {tuple(bias.shape)} {bias.dtype}")
    if mask is not None:
        if mask.ndim != 3 or tuple(mask.shape[1:]) != (n, n) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be (nW, {n}, {n}) float32; got {tuple(mask.shape)} {mask.dtype}")
        if mask.shape[0] == 0 or b % mask.shape[0] != 0:
            raise ValueError(f"the window count {b} must be a multiple of the mask's {mask.shape[0]} rows")
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v, bias and mask must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_window_attention takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_window_attention is forward-only; run it under torch.inference_mode()")


@functools.cache
def _launcher():
    fn = library().monai_window_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _planner():
    fn = library().monai_window_attention_plan
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_attention_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                          mask: torch.Tensor | None = None) -> dict:
    """What ``fused_window_attention`` launches for these CUDA tensors, without launching
    it: the kernel's instance ("mma" on the tensor cores, "fma" the float32 one, "generic"),
    the windows a block walks over, the blocks, the blocks an SM holds (0 where the
    instance does not work it out), the dynamic shared memory in bytes and the query rows
    a block."""
    _check(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_plan describes a CUDA launch; got a tensor on {q.device}")
    b, h, n, d = q.shape
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(q.device):
        err = _planner()(b, h, n, d, 0 if mask is None else mask.shape[0], _DTYPE_CODES[q.dtype],
                         int(all(t.data_ptr() % 16 == 0 for t in (q, k, v))), ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"window_attention_plan: error {err} for q {tuple(q.shape)} {q.dtype}")
    return {"instance": _INSTANCES[info[0]], "windows_per_block": info[1], "blocks": info[2],
            "blocks_per_sm": info[3], "smem_bytes": info[4], "rows_per_block": info[5]}


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q kᵀ + bias[h] + mask[b % nW]) v for q, k, v (B, H, N, D), q already scaled
    by D^-0.5; bias (H, N, N) float32; mask optional (nW, N, N) float32 with B a multiple
    of nW. Output (B, H, N, D) in q's dtype.

    CPU tensors run the plain version; CUDA tensors run the CUDA kernel (any N and any
    head dim whose key chunks fit the card's shared memory; past that the kernel refuses
    and this raises) and add one to ``fused_window_attention.launches``."""
    _check(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return fused_window_attention_plain(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_window_attention runs on CPU or CUDA tensors, not {q.device}")
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                          None if mask is None else mask.data_ptr(), out.data_ptr(), b, h, n, d,
                          0 if mask is None else mask.shape[0], _DTYPE_CODES[q.dtype],
                          torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_window_attention: CUDA launch failed with error {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, mask {None if mask is None else tuple(mask.shape)})")
    count_launch(fused_window_attention)
    return out


fused_window_attention.launches = 0
