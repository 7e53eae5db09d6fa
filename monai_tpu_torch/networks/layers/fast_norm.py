"""Instance norm, optionally followed by PReLU, on a Triton kernel.

Counterpart of monai_tpu/networks/layers/fast_norm.py::_in_norm (the JAX package's
hand-written instance norm; the PReLU that ADN applies next is fused in here). The
statistics are the two-moment f32 form of ``_in_stats``: mean ``m = Σx/n`` and
variance ``v = max(Σx²/n − m², 0)``, then ``y = (x − m)·rsqrt(v + eps)·γ + β`` and,
with a slope ``a`` (one value or one per channel), ``y = y if y >= 0 else a·y``.

What bounds it on the card: it is pure data movement — one read of x for the sums,
one more read of x and one write of y — and at the UNet's widest site, (18, 96³, 2) in
bfloat16, that is 3 x 64 MB. The design reads the channels-last ``(B, S, C)`` view in
row tiles that are contiguous in memory, splits each (batch, channel block) over
enough spatial chunks to fill the card, and reduces in two stages (partial sums per
chunk, then a fixed-order sum of the partials in every program of the second pass)
rather than with atomics, so the output is the same from run to run. The PReLU rides
in the normalize pass, so norm + activation costs one write instead of two.

``instance_norm_prelu_plain`` is the same function in plain PyTorch: the wrapper runs
it for CPU tensors, and it is the oracle on the card. For a CUDA tensor the wrapper
launches the kernel or raises; it never falls back. Forward only.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

__all__ = ["InstanceNorm", "instance_norm_prelu", "instance_norm_prelu_plain"]

# triton.language, bound by _triton_kernels() on the first launch: this module must
# import where triton is not installed, and the kernels below resolve `tl` through
# the module's globals when Triton compiles them.
tl = None


def _partial_sums_kernel(x_ptr, psum_ptr, psq_ptr, S, C, rows_per_prog, n_split,
                         BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    sp = tl.program_id(1)
    cb = tl.program_id(2)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = x_ptr + b.to(tl.int64) * S * C
    row0 = sp * rows_per_prog
    acc = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    for r in range(0, rows_per_prog, BLOCK_S):
        rows = row0 + r + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        v = tl.load(base + offs, mask=mask, other=0.0).to(tl.float32)
        acc += v
        acc2 += v * v
    out = (b * n_split + sp) * C + cols
    tl.store(psum_ptr + out, tl.sum(acc, axis=0), mask=cmask)
    tl.store(psq_ptr + out, tl.sum(acc2, axis=0), mask=cmask)


def _normalize_kernel(x_ptr, y_ptr, psum_ptr, psq_ptr, w_ptr, bias_ptr, slope_ptr,
                      S, C, rows_per_prog, n_split, inv_n, eps,
                      HAS_AFFINE: tl.constexpr, HAS_SLOPE: tl.constexpr, SLOPE_PER_C: tl.constexpr,
                      BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr, BLOCK_P: tl.constexpr):
    b = tl.program_id(0)
    sp = tl.program_id(1)
    cb = tl.program_id(2)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    # stage two of the reduce: every program sums the partials in the same order
    s = tl.zeros([BLOCK_C], dtype=tl.float32)
    s2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    for p0 in range(0, n_split, BLOCK_P):
        ps = p0 + tl.arange(0, BLOCK_P)
        pmask = (ps < n_split)[:, None] & cmask[None, :]
        poffs = (b * n_split + ps)[:, None] * C + cols[None, :]
        s += tl.sum(tl.load(psum_ptr + poffs, mask=pmask, other=0.0), axis=0)
        s2 += tl.sum(tl.load(psq_ptr + poffs, mask=pmask, other=0.0), axis=0)
    mean = s * inv_n
    var = tl.maximum(s2 * inv_n - mean * mean, 0.0)
    scale = 1.0 / tl.sqrt(var + eps)
    if HAS_AFFINE:
        scale = scale * tl.load(w_ptr + cols, mask=cmask, other=1.0).to(tl.float32)
        shift = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    else:
        shift = tl.zeros([BLOCK_C], dtype=tl.float32)
    if HAS_SLOPE:
        if SLOPE_PER_C:
            slope = tl.load(slope_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        else:
            slope = tl.zeros([BLOCK_C], dtype=tl.float32) + tl.load(slope_ptr).to(tl.float32)
    base = b.to(tl.int64) * S * C
    row0 = sp * rows_per_prog
    for r in range(0, rows_per_prog, BLOCK_S):
        rows = row0 + r + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None] & cmask[None, :]
        offs = base + rows.to(tl.int64)[:, None] * C + cols[None, :]
        v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        yv = (v - mean[None, :]) * scale[None, :] + shift[None, :]
        if HAS_SLOPE:
            yv = tl.where(yv >= 0, yv, yv * slope[None, :])
        tl.store(y_ptr + offs, yv.to(y_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _triton_kernels():
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_partial_sums_kernel), triton.jit(_normalize_kernel)


_TARGET_PROGRAMS = 1024  # per pass: several programs per SM on a 132-SM card
_BLOCK_P = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(batch: int, s: int, c: int) -> tuple[int, int, int, int]:
    """Tile sizes and the spatial split of ``(batch, s, c)``:
    (BLOCK_S, BLOCK_C, rows_per_prog, n_split), with rows_per_prog a multiple of BLOCK_S."""
    block_c = min(max(1 << (c - 1).bit_length(), 2), 64)
    block_s = max(2048 // block_c, 16)
    n_split = max(1, min(_cdiv(_TARGET_PROGRAMS, batch * _cdiv(c, block_c)), _cdiv(s, block_s)))
    rows_per_prog = _cdiv(_cdiv(s, n_split), block_s) * block_s
    return block_s, block_c, rows_per_prog, _cdiv(s, rows_per_prog)


def instance_norm_prelu_plain(x: torch.Tensor, weight: torch.Tensor | None = None,
                              bias: torch.Tensor | None = None, slope: torch.Tensor | None = None,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain-PyTorch version, with the same two-moment f32 statistics."""
    dims = tuple(range(2, x.ndim))
    n = math.prod(x.shape[2:])
    shape = (1, -1) + (1,) * (x.ndim - 2)
    xf = x.float()
    m = xf.sum(dims, keepdim=True) / n
    v = ((xf * xf).sum(dims, keepdim=True) / n - m * m).clamp_min(0.0)
    scale = torch.rsqrt(v + eps)
    if weight is not None:
        scale = scale * weight.float().view(shape)
    y = (xf - m) * scale
    if bias is not None:
        y = y + bias.float().view(shape)
    if slope is not None:
        a = slope.float().view(shape) if slope.numel() > 1 else slope.float().reshape(())
        y = torch.where(y >= 0, y, y * a)
    return y.to(x.dtype)


def _check(x, weight, bias, slope) -> None:
    if x.ndim < 3:
        raise ValueError(f"instance_norm_prelu takes (B, C, *spatial); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"instance_norm_prelu takes float32, bfloat16 or float16; got {x.dtype}")
    c = x.shape[1]
    if (weight is None) != (bias is None):
        raise ValueError("give both weight and bias, or neither")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and tuple(t.shape) != (c,):
            raise ValueError(f"{name} must have shape ({c},); got {tuple(t.shape)}")
    if slope is not None and (slope.ndim != 1 or slope.numel() not in (1, c)):
        raise ValueError(f"slope must have shape (1,) or ({c},); got {tuple(slope.shape)}")
    params = [t for t in (weight, bias, slope) if t is not None]
    if any(t.device != x.device for t in params):
        raise ValueError("x and the norm's parameters must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, *params]):
        raise RuntimeError("instance_norm_prelu is forward-only; run it under torch.inference_mode()")


def instance_norm_prelu(x: torch.Tensor, weight: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                        slope: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the spatial axes of ``x`` (B, C, *spatial), with optional affine
    ``weight``/``bias`` (C,) and optional PReLU ``slope`` (1,) or (C,); output in x's dtype.

    A CUDA ``x`` must be channels-last in memory (``x.permute(0, 2, ..., 1)`` contiguous,
    as ``torch.channels_last_3d`` gives); the Triton kernel runs and
    ``instance_norm_prelu.launches`` goes up by one. A CPU ``x`` runs the plain version."""
    _check(x, weight, bias, slope)
    if x.device.type == "cpu":
        return instance_norm_prelu_plain(x, weight, bias, slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_prelu runs on CPU or CUDA tensors, not {x.device}")
    to_last = (0, *range(2, x.ndim), 1)
    x3 = x.permute(to_last)
    if not x3.is_contiguous():
        raise ValueError("instance_norm_prelu takes a channels-last CUDA tensor "
                         "(x.contiguous(memory_format=torch.channels_last_3d))")
    if any(not t.is_contiguous() for t in (weight, bias, slope) if t is not None):
        raise ValueError("instance_norm_prelu takes contiguous parameters")
    partial_sums, normalize = _triton_kernels()
    bsz, c = x.shape[0], x.shape[1]
    s = x3[0, ..., 0].numel()
    block_s, block_c, rows_per_prog, n_split = _split(bsz, s, c)
    psum = torch.empty((bsz, n_split, c), dtype=torch.float32, device=x.device)
    psq = torch.empty_like(psum)
    y3 = torch.empty_like(x3, memory_format=torch.contiguous_format)
    grid = (bsz, n_split, _cdiv(c, block_c))
    with torch.cuda.device(x.device):
        partial_sums[grid](x3, psum, psq, s, c, rows_per_prog, n_split,
                           BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4)
        normalize[grid](x3, y3, psum, psq,
                        x3 if weight is None else weight, x3 if bias is None else bias,
                        x3 if slope is None else slope,
                        s, c, rows_per_prog, n_split, 1.0 / s, float(eps),
                        HAS_AFFINE=weight is not None, HAS_SLOPE=slope is not None,
                        SLOPE_PER_C=slope is not None and slope.numel() > 1,
                        BLOCK_S=block_s, BLOCK_C=block_c, BLOCK_P=_BLOCK_P, num_warps=4)
    instance_norm_prelu.launches += 1
    return y3.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


instance_norm_prelu.launches = 0


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` in channels-last memory (a no-op when it already is), as the kernel takes it;
    cuDNN may return NCDHW memory, e.g. for a 1-channel input."""
    if x.ndim in (4, 5):
        return x.contiguous(memory_format=torch.channels_last if x.ndim == 4 else torch.channels_last_3d)
    return x


class InstanceNorm(nn.Module):
    """Instance norm with torch's ``InstanceNorm{1,2,3}d`` parameter names (``weight`` and
    ``bias`` when ``affine``; none otherwise, and no running statistics), running
    ``instance_norm_prelu``. Called with a ``slope`` (1,) or (C,), it fuses the leaky or
    parametric ReLU that follows it into the same launch."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = False, device=None,
                 dtype=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device, dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device, dtype=dtype))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor, slope: torch.Tensor | None = None) -> torch.Tensor:
        return instance_norm_prelu(channels_last(x), self.weight, self.bias, slope, self.eps)

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}, affine={self.affine}"
