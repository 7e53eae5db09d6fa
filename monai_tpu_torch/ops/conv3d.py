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
the float32 sum of g. dx and dw come out in the types of x and w. ``wgrad_plan`` makes dw's
launch plan (route, brick, tiles, chunks) on the host, also without a card, as the kernel
makes it on the card; ``conv3d_3x3_wgrad_plan`` asks the card for its own.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
import torch.nn.functional as F

from ._build import library
from ..utils.counters import count_launch

__all__ = ["conv3d_3x3_same", "conv3d_3x3_same_plain", "conv3d_3x3_wgrad", "conv3d_3x3_wgrad_plain",
           "conv3d_3x3_wgrad_plan", "wgrad_plan"]

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
    if type(x) is not torch.Tensor:  # a fake or functional tensor: torch.export is tracing
        return torch.ops.monai_tpu_torch.conv3d_3x3_same(x, w, bias)
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


# The wrapper's forward as a torch operator, ``torch.ops.monai_tpu_torch.conv3d_3x3_same``:
# ``torch.export`` (the bundle's ``ckpt_export``, an inference forward) cannot trace a
# ctypes launch, and its graph calls the operator. Its kernel is the ctypes launch
# (``_forward``, which counts it) and its fake version gives the output's shape; it has no
# backward. An exported program so needs this module imported to run. The eager wrapper
# calls ``_forward`` directly: the dispatcher adds host time a call at the small sites,
# which are bound by it (``chip_smoke.py``'s ``operator_cost`` measures it).
@torch.library.custom_op("monai_tpu_torch::conv3d_3x3_same", mutates_args=())
def _conv3d_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    return _forward(x, w, bias)


@_conv3d_op.register_fake
def _(x, w, bias):
    return x.new_empty((*x.shape[:4], w.shape[4]))


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
    product of x shifted by the tap (zero-padded) with g over all voxels, in float32 (in
    float64 for float64 x and g, which the kernel does not take)."""
    n, d, h, w, ci = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.to(acc).reshape(-1, g.shape[-1])
    taps = [xp[:, kd:kd + d, kh:kh + h, kw:kw + w].reshape(-1, ci).T @ gf
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, ci, g.shape[-1]).to(x.dtype)


# The weight-gradient kernel's plan, as csrc/conv3d_3x3_wgrad.cu's make_plan makes it
_WGRAD_ROUTES = ("mma", "fma", "small")
_MMA_ROWS, _MMA_MAX_HALO, _MMA_THREADS = 128, 640, 288
_FMA_THREADS, _FMA_GROUPS, _FMA_MAX_PCO, _FMA_MAX_CIT = 432, 48, 12, 32
_FMA_LINE, _FMA_MAX_ROWS, _FMA_STAGE_BYTES, _FMA_BRICK_COST = 32, 256, 110592, 2048
_SMALL_SLOTS, _SMALL_ROWS = 4, 24
H100_SMS = 132
_SM_SHARED, _SM_REGISTERS = 233472, 65536  # an H100 SM's shared memory (1 KB of it reserved a block), registers
_PLAN_KEYS = ("route", "chunks", "partial", "blocks", "threads", "smem", "per_sm", "rc", "ro", "pci", "pco", "splits",
              "bd", "bh", "bw", "tiles_ci", "tiles_co", "bricks", "per_chunk")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(a: int) -> int:
    return _cdiv(a, 4) * 4


def _mma_brick(d: int, h: int, w: int) -> tuple[int, int, int]:
    """The mma route's brick: of up to 128 voxels whose halo holds at most 640, the one
    that loads the fewest brick rows plus halo voxels over the volume."""
    best, brick = None, None
    for bw in range(1, min(w, 32) + 1):
        for bh in range(1, min(h, 32) + 1):
            if bw * bh > _MMA_ROWS:
                break
            bd = min(d, _MMA_ROWS // (bw * bh))
            while bd > 1 and (bd + 2) * (bh + 2) * (bw + 2) > _MMA_MAX_HALO:
                bd -= 1
            halo = (bd + 2) * (bh + 2) * (bw + 2)
            if halo > _MMA_MAX_HALO:
                continue
            cost = _cdiv(d, bd) * _cdiv(h, bh) * _cdiv(w, bw) * (_MMA_ROWS + halo)
            if best is None or cost < best or (cost == best and bw > brick[2]):
                best, brick = cost, (bd, bh, bw)
    return brick


def _fma_brick(d: int, h: int, w: int, ci_tile: int, co_tile: int) -> tuple[int, int, int]:
    """The fma route's brick: lines of W split evenly into pieces of at most 32; of the
    (bd, bh) whose float32 stage (halo x CI tile, rows x CO tile) fits 110592 bytes and whose
    bricks hold at most 256 voxels, the one that stages the fewest floats over the volume,
    a brick's fixed cost counted as 2048 floats (the first such in bd, then bh order)."""
    bw = _cdiv(w, _cdiv(w, _FMA_LINE))
    best, brick = None, (1, 1, bw)
    for bd in range(1, min(d, 8) + 1):
        for bh in range(1, min(h, 32) + 1):
            rows, halo = bd * bh * bw, (bd + 2) * (bh + 2) * (bw + 2)
            if rows > _FMA_MAX_ROWS or 4 * (_round4(halo * ci_tile) + _round4(rows * co_tile)) > _FMA_STAGE_BYTES:
                continue
            cost = _cdiv(d, bd) * _cdiv(h, bh) * _cdiv(w, bw) * (halo * ci_tile + rows * co_tile + _FMA_BRICK_COST)
            if best is None or cost < best:
                best, brick = cost, (bd, bh, bw)
    return brick


def _pick_groups(groups: int, most: int) -> int:
    """Of 1..most groups a block, the one that pads ``groups`` the least; the largest such."""
    best = 1
    for p in range(2, most + 1):
        if _cdiv(groups, p) * p <= _cdiv(groups, best) * best:
            best = p
    return best


def _pick_chunks(bricks: int, unit: int, tiles: int, slots: int) -> int:
    """The chunks of K (each ``unit`` bricks or voxels at least) with the least time, counted
    as the waves of tiles x chunks blocks over the card's ``slots`` times the bricks a chunk
    plus a block's fixed cost (``unit``: its first load and its partials); the fewest such.
    Up to 4 times the chunks that fill the card once."""
    best, chunks = None, 1
    for c in range(1, min(_cdiv(bricks, unit), 4 * _cdiv(slots, tiles)) + 1):
        per = _cdiv(bricks, c)
        n = _cdiv(bricks, per)
        cost = _cdiv(tiles * n, slots) * (per + unit)
        if best is None or cost < best:
            best, chunks = cost, n
    return chunks


def _resident_model(route: str, threads: int, smem: int) -> int:
    """Blocks an H100 SM holds, for a plan made without a card: its shared memory, and its
    registers at about what ptxas gives a thread (the mma route 168, the fma route 128, the
    small route 100)."""
    regs = {"mma": 168, "fma": 128, "small": 100}[route]
    return max(1, min(_SM_SHARED // (smem + 1024), _SM_REGISTERS // (regs * _cdiv(threads, 32) * 32)))


def wgrad_plan(shape: tuple[int, ...], co: int, dtype: torch.dtype, aligned: bool = True, sms: int = H100_SMS,
               resident: int | None = None) -> dict:
    """What ``conv3d_3x3_wgrad`` launches for x of ``shape`` (N, D, H, W, CI) and g of ``co``
    channels, without a card: the plan csrc/conv3d_3x3_wgrad.cu makes (``make_plan``).
    ``aligned``: x and g are 16-byte aligned; ``sms``: the card's SMs; ``resident``: the
    blocks of the plan's kernel an SM holds (the card's occupancy; by default a model of the
    H100, ``_resident_model``).

    Returns a dict: ``route`` "mma" (tensor cores: bfloat16 and float16 at CI, CO multiples
    of 8, aligned), "small" (CI and CO of 1 or 2) or "fma" (the rest, float32 on the FMA
    units); ``rc`` x ``ro`` the register tile of (ci, co) a thread (the mma route: its CI and
    CO tile), ``pci`` x ``pco`` the channel groups a block and ``splits`` the groups of
    lines they are split over (fma), so the CI and CO tiles are ``rc pci`` and ``ro pco``,
    ``tiles_ci`` x ``tiles_co`` of them; the brick ``bd`` x ``bh`` x ``bw`` (on the small
    route a strip of 32 columns by up to 24 rows) and the ``bricks`` over the volume; ``threads``, the dynamic shared memory
    ``smem`` in bytes, ``per_sm`` (= resident); K split into ``chunks`` of ``per_chunk``
    bricks, one chunk a block, so ``blocks`` = tiles x chunks; the float32 ``partial`` sums
    of the first launch (0 with one chunk: it writes dw itself) and the ``launches``."""
    n, d, h, w, ci = shape
    code = _DTYPE_CODES[dtype]
    route = "mma" if code != 0 and aligned and ci % 8 == 0 and co % 8 == 0 else \
        "small" if ci <= 2 and co <= 2 else "fma"
    splits = pci = pco = 1
    if route == "mma":
        rc, ro = 32 if ci % 32 == 0 else 16, 32 if co % 32 == 0 else 16 if co % 16 == 0 else 8
        bd, bh, bw = _mma_brick(d, h, w)
        halo = (bd + 2) * (bh + 2) * (bw + 2)
        xs_bytes = _cdiv(halo * (rc + 8) * 2, 128) * 128
        smem, threads = 2 * (xs_bytes + _MMA_ROWS * (ro + 8) * 2), _MMA_THREADS
    elif route == "small":  # strips of 32 columns by up to 24 rows of one plane
        rc, ro, bd, bh, bw, smem, threads = ci, co, 1, _cdiv(h, _cdiv(h, _SMALL_ROWS)), 32, 0, 96 * _SMALL_SLOTS
    else:
        rc, ro = min(ci, 2) if ci <= 2 else 4, 2 if co <= 2 else 4
        pco = _pick_groups(_cdiv(co, ro), _FMA_MAX_PCO)
        pci = _pick_groups(_cdiv(ci, rc), min(_FMA_GROUPS // pco, _FMA_MAX_CIT // rc))
        splits = max(1, _FMA_THREADS // (9 * pci * pco))
        threads = 9 * pci * pco * splits
        bd, bh, bw = _fma_brick(d, h, w, rc * pci, ro * pco)
        rows, halo = bd * bh * bw, (bd + 2) * (bh + 2) * (bw + 2)
        stage = _round4(halo * rc * pci) + _round4(rows * ro * pco)
        smem = 4 * max(2 * stage, threads * 3 * rc * ro if splits > 1 else 0)
    tiles_ci, tiles_co = _cdiv(ci, rc * pci), _cdiv(co, ro * pco)
    bricks = n * _cdiv(d, bd) * _cdiv(h, bh) * _cdiv(w, bw)
    per_sm = resident if resident is not None else _resident_model(route, threads, smem)
    chunks = _pick_chunks(bricks, _SMALL_SLOTS if route == "small" else 1, tiles_ci * tiles_co, sms * per_sm)
    per_chunk = _cdiv(bricks, chunks)
    return {"route": route, "chunks": chunks, "partial": chunks * 27 * ci * co if chunks > 1 else 0,
            "blocks": tiles_ci * tiles_co * chunks, "threads": threads, "smem": smem, "per_sm": per_sm, "rc": rc,
            "ro": ro, "pci": pci, "pco": pco, "splits": splits, "bd": bd, "bh": bh, "bw": bw, "tiles_ci": tiles_ci,
            "tiles_co": tiles_co, "bricks": bricks, "per_chunk": per_chunk, "launches": 2 if chunks > 1 else 1}


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
    """The kernel's own plan of its launch on card ``index`` (the values of _PLAN_KEYS)."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(index):
        err = _wgrad_fns()[0](*shape, co, _DTYPE_CODES[dtype], int(aligned), out)
    if err != 0:
        raise RuntimeError(f"conv3d_3x3_wgrad: no plan for x {shape} CO {co} {dtype} (CUDA error {err})")
    return tuple(out)


def conv3d_3x3_wgrad_plan(x: torch.Tensor, g: torch.Tensor) -> dict:
    """What ``conv3d_3x3_wgrad`` launches for CUDA tensors x and g, as the kernel's own plan
    on their card says, without launching it: the keys of ``wgrad_plan``, which makes the
    same plan on the host from the card's SM count and ``per_sm``."""
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    plan = dict(zip(_PLAN_KEYS, _wgrad_plan(x.device.index, tuple(x.shape), g.shape[-1], x.dtype, aligned)))
    plan["route"] = _WGRAD_ROUTES[plan["route"]]
    plan["launches"] = 2 if plan["chunks"] > 1 else 1
    return plan


def conv3d_3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``conv3d_3x3_same``: x (N,D,H,W,CI) and g (N,D,H,W,CO),
    contiguous, of one type -> dw (3,3,3,CI,CO) in that type, summed in float32.

    CPU tensors run the plain version; CUDA tensors run the kernel (two launches: the
    chunks' partial sums, then their sum in a fixed order; one where the plan has one
    chunk) and add one to ``conv3d_3x3_wgrad.launches``."""
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
    partial = torch.empty(plan["partial"], dtype=torch.float32, device=x.device) if plan["partial"] else None
    with torch.cuda.device(x.device):
        err = _wgrad_fns()[1](x.data_ptr(), g.data_ptr(), dw.data_ptr(), None if partial is None else
                              partial.data_ptr(), *x.shape, co,
                              _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_3x3_wgrad: CUDA launch failed with error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, CO {co}, plan {plan})")
    count_launch(conv3d_3x3_wgrad)
    return dw


conv3d_3x3_wgrad.launches = 0
