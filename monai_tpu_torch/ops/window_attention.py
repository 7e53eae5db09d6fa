"""Fused windowed attention, softmax(q kᵀ + bias + mask) v, on a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_window_attention.py::fused_window_attention. The
kernel is ``csrc/window_attention.cu`` (its header says what bounds it on the card and
what the design does about that). ``fused_window_attention_plain`` is the same function
in plain PyTorch, and not the XLA formulation: the scores and the softmax are float32,
the normalised probabilities are rounded to the input type, and p·v accumulates in
float32, as the TPU kernel does. The wrapper runs it for tensors on the CPU, and it is
the oracle the kernel is held to on the card. For a CUDA tensor the wrapper launches the
kernel or raises; it never falls back. ``window_attention_plan`` says which of the kernel's
instances a launch runs; ``attention_fwd_plan`` makes the float32 tensor-core instance's
plan on the host, as the kernel makes it on the card.

Under autograd the wrapper is the counterpart of the JAX custom VJP (``_vjp_fwd`` and
``_vjp_bwd``): the forward kernel also writes each score row's log-sum-exp, and the
backward is ``fused_window_attention_backward``, the kernels of
``csrc/window_attention_bwd.cu`` (its plain version
``fused_window_attention_backward_plain``), which give dq, dk, dv and dbias; the mask gets
no grad, as in the JAX rule. ``attention_bwd_plan`` makes the backward's launch plan on the
host, as the kernel makes it on the card (``window_attention_backward_plan``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ._build import library
from ..utils.counters import count_launch

__all__ = ["attention_bwd_plan", "attention_fwd_plan", "fused_window_attention", "fused_window_attention_backward",
           "fused_window_attention_backward_plain", "fused_window_attention_plain", "window_attention_backward_plan",
           "window_attention_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
H100_SMS = 132
# an H100 SM's shared memory (1 KB of it reserved a block) and registers; a block's most
# shared memory; about the registers ptxas gives a thread of the backward's main launch
# (175-249 by instance)
_SM_SHARED, _SM_REGISTERS, _BLOCK_SHARED, _BWD_REGS = 233472, 65536, 232448, 192
_FWD_REGS = {4: 128, 2: 255}  # the float32 forward's registers a thread by key splits (its launch bounds)
_INSTANCES = ("mma", "fma", "generic", "tf32x3")


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


@functools.cache
def _launcher():
    fn = library().monai_window_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    it: the kernel's instance ("mma" on the tensor cores in bfloat16 and float16, "tf32x3"
    on the tensor cores in float32, "fma" for inputs that are not 16-byte aligned,
    "generic"), the windows a block walks over, the blocks, the blocks an SM holds (0 where
    the instance does not work it out), the dynamic shared memory in bytes and the query
    rows a block. ``attention_fwd_plan`` makes the float32 instance's plan on the host."""
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


# The float32 tensor-core instance's plan (csrc/window_attention.cu, ``plan_tf32``). Each 16
# query rows of a block are a group of 4 warps, one a quarter of the keys, at D = 8 and N <=
# 352, else of 2.
_FWD_HEAD_DIMS, _FWD_MAX_N, _FWD_ROWS = (8, 16, 32), 512, (64, 32, 16)


def _fwd_key_splits(n: int, d: int) -> int:
    return 4 if d == 8 and _cdiv(n, 8) <= 44 else 2


def _fwd_smem(rows: int, n: int, d: int, stages: int) -> int:
    """The float32 instance's shared memory in bytes (``tf32_smem``): the addend tile (rows x
    lda floats, lda N rounded up to 8, plus 8 where that is a multiple of 16), ``stages``
    buffers of K (rows of 8, 16 or 48 floats at D = 8, 16, 32) and V (rows of D + 4) for N
    rounded up to 8 keys, and the groups' exchange (each warp's row max and sum; the partial
    outputs of all warps of a group but its first)."""
    keys, ks = _cdiv(n, 8) * 8, _fwd_key_splits(n, d)
    lda = keys + 8 if keys % 16 == 0 else keys
    kv_ld = (48 if d == 32 else d) + d + 4
    return 4 * (rows * lda + stages * keys * kv_ld + 2 * ks * rows + (ks - 1) * (rows // 16) * (d // 8) * 128)


def attention_fwd_plan(b: int, h: int, n: int, d: int, nw: int, sms: int = H100_SMS,
                       resident: int | None = None) -> dict:
    """What ``fused_window_attention`` launches for float32 q, k, v (B, H, N, D) = (b, h, n,
    d), 16-byte aligned, under ``nw`` mask rows (0: no mask), without a card: the plan of the
    float32 tensor-core instance that csrc/window_attention.cu makes (``plan_tf32``).
    ``sms``: the card's SMs; ``resident``: the blocks an SM holds (the card's occupancy; by
    default a model of the H100 from the shared memory and ``_FWD_REGS`` registers a
    thread).

    Returns the keys of ``window_attention_plan`` (``instance`` "tf32x3", the
    ``rows_per_block``: 64, or 32 or 16 where a 64-row addend tile does not fit beside one
    buffer of K and V; ``windows_per_block``, ``blocks``, ``blocks_per_sm`` and
    ``smem_bytes``), the ``stages`` of K and V (2: double-buffered) and the ``key_splits``
    (warps a group of 16 query rows, each a part of the keys; a block has 2 x key_splits x
    rows_per_block threads). A block owns ``rows_per_block`` query rows of one head and one
    mask row (its windows b with b % nW that row) and walks ``windows_per_block`` of that
    row's windows; without a mask the windows are one row. Raises ValueError for a shape
    the instance does not take."""
    nw = nw or 1
    if d not in _FWD_HEAD_DIMS or not 0 < n <= _FWD_MAX_N or min(b, h, nw) <= 0 or b % nw:
        raise ValueError(f"attention_fwd_plan: the float32 tensor-core instance takes D in {_FWD_HEAD_DIMS} and N up "
                         f"to {_FWD_MAX_N}; got (B, H, N, D) = ({b}, {h}, {n}, {d}) under {nw} mask rows")
    rows, stages = next((r, st) for r in _FWD_ROWS for st in (2, 1) if _fwd_smem(r, n, d, st) <= _BLOCK_SHARED)
    ks = _fwd_key_splits(n, d)
    smem = _fwd_smem(rows, n, d, stages)
    per_sm = resident if resident is not None else max(1, min(_SM_SHARED // (smem + 1024),
                                                               _SM_REGISTERS // (_FWD_REGS[ks] * 2 * ks * rows)))
    n_qtiles, per_row = _cdiv(n, rows), b // nw
    wb, splits = _pick_runs(per_row, n_qtiles * h * nw, sms * per_sm, fill=True)
    return {"instance": "tf32x3", "windows_per_block": wb, "blocks": n_qtiles * h * nw * splits,
            "blocks_per_sm": per_sm, "smem_bytes": smem, "rows_per_block": rows, "stages": stages,
            "key_splits": ks}


def _forward(q, k, v, bias, mask, with_lse: bool = False):
    """The CUDA forward; with ``with_lse`` also each score row's float32 log-sum-exp
    (B, H, N), else None."""
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                          None if mask is None else mask.data_ptr(), out.data_ptr(),
                          None if lse is None else lse.data_ptr(), b, h, n, d,
                          0 if mask is None else mask.shape[0], _DTYPE_CODES[q.dtype],
                          torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_window_attention: CUDA launch failed with error {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, mask {None if mask is None else tuple(mask.shape)})")
    count_launch(fused_window_attention)
    return out, lse


class _WindowAttention(torch.autograd.Function):
    """The JAX rule: the forward saves q, k, v, bias, mask, the output and (on the card)
    the log-sum-exp; the backward gives dq, dk, dv and dbias, and no grad to the mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        if q.device.type == "cpu":
            out, lse = fused_window_attention_plain(q, k, v, bias, mask), None
        else:
            out, lse = _forward(q, k, v, bias, mask, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, mask, out, lse)
        return out

    @staticmethod
    @once_differentiable  # the backward kernels have no backward of their own
    def backward(ctx, g):
        q, k, v, bias, mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = fused_window_attention_backward(q, k, v, bias, mask, out, g.contiguous(), lse)
        return dq, dk, dv, dbias, None


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q kᵀ + bias[h] + mask[b % nW]) v for q, k, v (B, H, N, D), q already scaled
    by D^-0.5; bias (H, N, N) float32; mask optional (nW, N, N) float32 with B a multiple
    of nW. Output (B, H, N, D) in q's dtype.

    CPU tensors run the plain version; CUDA tensors run the CUDA kernel (any N and any
    head dim whose key chunks fit the card's shared memory; past that the kernel refuses
    and this raises) and add one to ``fused_window_attention.launches``. Where autograd
    records (q, k, v or bias requires a grad), the backward runs
    ``fused_window_attention_backward``."""
    _check(q, k, v, bias, mask)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention runs on CPU or CUDA tensors, not {q.device}")
    if type(q) is not torch.Tensor:  # a fake or functional tensor: torch.export is tracing
        return torch.ops.monai_tpu_torch.fused_window_attention(q, k, v, bias, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _WindowAttention.apply(q, k, v, bias, mask)
    return _inference(q, k, v, bias, mask)


def _inference(q, k, v, bias, mask):
    if q.device.type == "cpu":
        return fused_window_attention_plain(q, k, v, bias, mask)
    return _forward(q, k, v, bias, mask)[0]


fused_window_attention.launches = 0


# The inference forward (no log-sum-exp) as a torch operator,
# ``torch.ops.monai_tpu_torch.fused_window_attention``, which a ``torch.export`` graph calls
# (as kernel 1's, ``ops/conv3d.py``): its kernel is the ctypes launch (``_forward``, which
# counts it), its fake version the output ``_forward`` allocates; it has no backward.
@torch.library.custom_op("monai_tpu_torch::fused_window_attention", mutates_args=())
def _window_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                         mask: torch.Tensor | None) -> torch.Tensor:
    return _inference(q, k, v, bias, mask)


@_window_attention_op.register_fake
def _(q, k, v, bias, mask):
    return torch.empty_like(q)


def fused_window_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                                          mask: torch.Tensor | None, out: torch.Tensor,
                                          grad_out: torch.Tensor) -> tuple:
    """Plain-PyTorch version of ``fused_window_attention_backward``, in float32 (float64
    for float64 tensors): P the softmax of the scores, dV = round(P)ᵀ dO with P rounded to
    q's dtype as the forward rounds it, D = Σ_d dO·O from the forward's output, dS = P ∘
    (dO vᵀ − D), dQ = dS k, dK = dSᵀ q, dbias the sum of dS over the windows. dq, dk, dv in
    q's dtype, dbias float32 (float64)."""
    b, h, n, _ = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    s += bias.to(acc)
    if mask is not None:
        nw = mask.shape[0]
        s.view(b // nw, nw, h, n, n).add_(mask.to(acc)[None, :, None])
    p = torch.softmax(s, dim=-1)
    del s
    g = grad_out.to(acc)
    dv = torch.matmul(p.to(q.dtype).to(acc).transpose(-1, -2), g)
    ds = torch.matmul(g, v.to(acc).transpose(-1, -2))
    ds -= (g * out.to(acc)).sum(-1, keepdim=True)
    ds *= p
    del p
    dq = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), ds.sum(0)


# The backward's launch plan (csrc/window_attention_bwd.cu, ``make_plan``): its keys, in
# the order the kernel's plan function writes them, and its routes by code.
_BWD_PLAN_KEYS = ("route", "head_dim", "key_tile", "query_rows", "key_tiles", "chunks", "threads", "smem_bytes",
                  "blocks_per_sm", "windows_per_block", "splits", "blocks", "dq_partials", "dbias_partials", "cluster",
                  "launches")
_BWD_ROUTES = ("tf32x3",)
_BWD_THREADS, _BWD_SCORES = 256, 2048  # a main block's threads; the scores of its step (query rows x key tile)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bwd_smem(n: int, kt: int, dp: int) -> int:
    """The main launch's shared memory in bytes (``main_smem_bytes``): the (N, KT) addend and
    dbias tiles; k, v, q and dO (rows of the padded D + 4 floats), two buffers each; round(P)
    and dS; dQ's partials of each key split (rows of 24 floats at D = 8, else D + 8); lse
    and D, two buffers each."""
    qt = _BWD_SCORES // kt
    tiles = qt // 16 * (dp // 8)  # dQ's 16 x 8 tiles a step, over 8 warps
    return 4 * (2 * n * kt + 4 * kt * (dp + 4) + 4 * qt * (dp + 4) + 2 * _BWD_SCORES
                + (1 if tiles >= 8 else 8 // tiles) * qt * (24 if dp == 8 else dp + 8) + 4 * qt)


def _pick_runs(windows: int, base: int, slots: int, fill: bool = False) -> tuple[int, int]:
    """The runs of windows (the backward's ``pick_splits``, the float32 forward's
    ``split_rows``) with the fewest waves of ``base`` x runs blocks over ``slots`` times the
    windows a run plus one (a block's fixed costs: its first staging, its addend tile or
    dbias partial); the fewest runs of those. ``fill`` (the forward's rule): no fewer than
    ``slots`` blocks where ``base`` x ``windows`` blocks would be that many. Returns
    (windows a run, runs)."""
    best, out = None, (windows, 1)
    for s in range(1, windows + 1):
        run = _cdiv(windows, s)
        if _cdiv(windows, run) != s or (fill and base * s < slots <= base * windows):
            continue
        cost = _cdiv(base * s, slots) * (run + 1)
        if best is None or cost < best:
            best, out = cost, (run, s)
    return out


def _bwd_refused(b: int, h: int, n: int, d: int) -> ValueError:
    return ValueError(f"fused_window_attention_backward: the kernel takes head dims up to 32 and N up to what its "
                      f"(N, 16) float32 tiles leave of the shared memory; got (B, H, N, D) = ({b}, {h}, {n}, {d})")


def attention_bwd_plan(b: int, h: int, n: int, d: int, nw: int, dtype: torch.dtype, sms: int = H100_SMS,
                       resident: int | None = None) -> dict:
    """What ``fused_window_attention_backward`` launches for (B, H, N, D) = (b, h, n, d) under
    ``nw`` mask rows (0: no mask), without a card: the plan csrc/window_attention_bwd.cu
    makes (``make_plan``). ``sms``: the card's SMs; ``resident``: the main blocks an SM holds
    (the card's occupancy; by default a model of the H100 from the shared memory and
    ``_BWD_REGS`` registers a thread).

    Returns the keys of ``window_attention_backward_plan``: the ``route`` ("tf32x3": D, the
    main launch with its products on mma.sync in 3xTF32, the partials' sum); ``head_dim``,
    D rounded up to 8, 16 or 32; the ``key_tile`` of a block (64, else 32 or 16, the widest whose (N, KT) addend and dbias
    tiles fit the block's shared memory) and the ``query_rows`` of its step (2048 scores
    a step); the ``key_tiles`` over N and the ``chunks`` of query rows a window; the
    ``threads`` and shared memory (``smem_bytes``) of a main block and the
    ``blocks_per_sm``; the ``windows_per_block`` of a run and the runs (``splits``); the
    main ``blocks`` (heads x key tiles x runs); the ``dq_partials`` (the key tiles where
    more than one, else 0) and ``dbias_partials`` (the runs where more than one, else 0)
    that the last launch adds in order; the ``cluster`` size (1: no clusters); and the
    CUDA ``launches`` (2 where there are no partials, else 3). Raises ValueError for a
    shape the kernel refuses."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_window_attention_backward takes float32, bfloat16 or float16, not {dtype}")
    nw = nw or 1
    if min(b, h, n, d, nw) <= 0 or b % nw:
        raise ValueError(f"attention_bwd_plan: no plan for (B, H, N, D) = ({b}, {h}, {n}, {d}) under {nw} mask rows")
    dp = 8 if d <= 8 else 16 if d <= 16 else 32 if d <= 32 else 0
    kt = next((t for t in (64, 32, 16) if dp and _bwd_smem(n, t, dp) <= _BLOCK_SHARED), 0)
    if not kt:
        raise _bwd_refused(b, h, n, d)
    smem, nkt = _bwd_smem(n, kt, dp), _cdiv(n, kt)
    per_sm = resident if resident is not None else max(1, min(_SM_SHARED // (smem + 1024),
                                                               _SM_REGISTERS // (_BWD_REGS * _BWD_THREADS)))
    splits = _pick_runs(b, h * nkt, sms * per_sm)[1]
    return {"route": "tf32x3", "head_dim": dp, "key_tile": kt, "query_rows": _BWD_SCORES // kt, "key_tiles": nkt,
            "chunks": _cdiv(n, _BWD_SCORES // kt), "threads": _BWD_THREADS, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "windows_per_block": _cdiv(b, splits), "splits": splits,
            "blocks": h * nkt * splits, "dq_partials": nkt if nkt > 1 else 0,
            "dbias_partials": splits if splits > 1 else 0, "cluster": 1,
            "launches": 3 if nkt > 1 or splits > 1 else 2}


@functools.cache
def _bwd_fns():
    lib = library()
    plan, run = lib.monai_window_attention_bwd_plan, lib.monai_window_attention_bwd
    plan.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    run.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    run.restype = ctypes.c_int
    return plan, run


def _bwd_plan(b: int, h: int, n: int, d: int, nw: int, dtype: torch.dtype, device: torch.device) -> dict:
    info = (ctypes.c_longlong * len(_BWD_PLAN_KEYS))()
    with torch.cuda.device(device):
        err = _bwd_fns()[0](b, h, n, d, nw, _DTYPE_CODES[dtype], ctypes.addressof(info))
    if err == 1:
        raise _bwd_refused(b, h, n, d)
    if err != 0:
        raise RuntimeError(f"window_attention_backward_plan: error {err} for ({b}, {h}, {n}, {d}) {dtype}")
    plan = dict(zip(_BWD_PLAN_KEYS, info))
    plan["route"] = _BWD_ROUTES[plan["route"]]
    return plan


def window_attention_backward_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                                   mask: torch.Tensor | None = None) -> dict:
    """What ``fused_window_attention_backward`` launches for these CUDA tensors, as the
    kernel's own plan on their card says, without launching it: the keys of
    ``attention_bwd_plan``, which makes the same plan on the host from the card's SM count
    and ``blocks_per_sm``. Raises ValueError naming the shape where the kernel refuses it."""
    _check(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_backward_plan describes a CUDA launch; got a tensor on {q.device}")
    b, h, n, d = q.shape
    return _bwd_plan(b, h, n, d, 0 if mask is None else mask.shape[0], q.dtype, q.device)


def fused_window_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                                    mask: torch.Tensor | None, out: torch.Tensor, grad_out: torch.Tensor,
                                    lse: torch.Tensor | None = None) -> tuple:
    """dq, dk, dv (q's dtype) and dbias (float32) of ``fused_window_attention`` at output
    grad ``grad_out``, given its output ``out`` and, on the card, the forward's
    log-sum-exp ``lse`` (B, H, N) float32.

    CPU tensors run the plain version; CUDA tensors run the kernels of
    ``csrc/window_attention_bwd.cu`` on the route their plan names (D; the main launch,
    which gives dK, dV and dQ's and dbias's partials or themselves; the partials' sum where
    there are any) or raise, add one to ``fused_window_attention_backward.launches`` and
    the CUDA launches made to its ``cuda_launches``. Deterministic: the same inputs give
    the same bits."""
    _check(q, k, v, bias, mask)
    for name, t in (("out", out), ("grad_out", grad_out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(q.shape)} {q.dtype} tensor on {q.device}")
    if q.device.type == "cpu":
        return fused_window_attention_backward_plain(q, k, v, bias, mask, out, grad_out)
    if q.device.type != "cuda":
        raise ValueError(f"fused_window_attention_backward runs on CPU or CUDA tensors, not {q.device}")
    b, h, n, d = q.shape
    if lse is None or tuple(lse.shape) != (b, h, n) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"fused_window_attention_backward needs the forward's ({b}, {h}, {n}) float32 log-sum-exp "
                         f"on {q.device}")
    plan = _bwd_plan(b, h, n, d, 0 if mask is None else mask.shape[0], q.dtype, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    dq_part = (torch.empty((plan["dq_partials"], b, h, n, d), dtype=torch.float32, device=q.device)
               if plan["dq_partials"] else None)
    db_part = (torch.empty((plan["dbias_partials"], h, n, n), dtype=torch.float32, device=q.device)
               if plan["dbias_partials"] else None)
    ran = (ctypes.c_int * 2)()
    with torch.cuda.device(q.device):
        err = _bwd_fns()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                            None if mask is None else mask.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            dbias.data_ptr(), None if dq_part is None else dq_part.data_ptr(),
                            None if db_part is None else db_part.data_ptr(), b, h, n, d,
                            0 if mask is None else mask.shape[0], _DTYPE_CODES[q.dtype],
                            torch.cuda.current_stream(q.device).cuda_stream, ctypes.addressof(ran))
    if err != 0:
        raise RuntimeError(f"fused_window_attention_backward: CUDA launch failed with error {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, mask {None if mask is None else tuple(mask.shape)})")
    if _BWD_ROUTES[ran[0]] != plan["route"] or ran[1] != plan["launches"]:
        raise RuntimeError(f"fused_window_attention_backward: ran route {ran[0]} with {ran[1]} launches, the plan "
                           f"names {plan['route']} with {plan['launches']}")
    count_launch(fused_window_attention_backward)
    count_launch(fused_window_attention_backward, ran[1], "cuda_launches")
    return dq, dk, dv, dbias


fused_window_attention_backward.launches = 0
fused_window_attention_backward.cuda_launches = 0
