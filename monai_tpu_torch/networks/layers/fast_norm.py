"""Instance norm, optionally followed by PReLU, on a CUDA kernel.

Counterpart of monai_tpu/networks/layers/fast_norm.py::_in_norm (the JAX package's
hand-written instance norm; the PReLU that ADN applies next is fused in here). The
statistics are the two-moment f32 form of ``_in_stats``: mean ``m = Σx/n`` and
variance ``v = max(Σx²/n − m², 0)``, then ``y = (x − m)·rsqrt(v + eps)·γ + β`` and,
with a slope ``a`` (one value or one per channel), ``y = y if y >= 0 else a·y``.

What bounds it on the card: it is pure data movement, so one read of x and one write of
y is the least it can take; at the UNet's widest site, (18, 96³, 2) in bfloat16, that
is 2 x 64 MB. The kernel is ``csrc/instance_norm.cu``: 16-byte loads and stores whose
channels stay fixed per thread (no padded channel lanes at C = 24), one launch a site,
and a single pass through shared memory where one instance's slab (or a group of its
channels) fits a block; elsewhere one cooperative launch over the whole card, with a
grid-wide barrier between the sums and the normalize pass. Partials combine in a fixed
order rather than by atomics, so the output is the same from run to run. ``instance_norm_plan`` says which of these a shape takes.

``instance_norm_prelu_plain`` is the same function in plain PyTorch: the wrapper runs
it for CPU tensors, and it is the oracle on the card. For a CUDA tensor the wrapper
launches the kernel or raises; it never falls back.

Under autograd the wrapper is the counterpart of ``_in_norm`` with ``_in_norm_fwd`` and
``_in_norm_bwd``, the PReLU's backward fused in: the forward kernel also writes the
per-(B, C) mean and rsqrt(var + eps) in float32, and ``instance_norm_prelu_backward``
(the backward kernel of ``csrc/instance_norm.cu``; its plain version
``instance_norm_prelu_backward_plain``) gives dx and the sums from which the grads of the
weight, bias and slope come. It saves x and the statistics, not the output (with a
weight of 0 the output holds nothing of x^). A slope's grad is the sum of g z over
z < 0, z the normalised value before the slope; z >= 0 takes the positive branch in both
directions.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable
from torch import nn

from ...utils.counters import count_launch

__all__ = ["InstanceNorm", "instance_norm_backward_plan", "instance_norm_plan", "instance_norm_prelu",
           "instance_norm_prelu_backward", "instance_norm_prelu_backward_plain", "instance_norm_prelu_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PATHS = {"onchip": 0, "persistent": 1, "general": 1}
_BWD_PATHS = {"onchip": 2, "persistent": 3, "general": 3}  # the backward's kernels (csrc kernel_of)
_CHANNELS_LAST = {4: torch.channels_last, 5: torch.channels_last_3d}
_MAX_THREADS = 256  # a block's threads, at most (csrc/instance_norm.cu kMaxThreads)
_MIN_ROW_BYTES = 32  # an on-chip channel group reads at least one 32-byte sector a voxel
# The backward's persistent grid reads a unit's rows (its channels of a voxel) in turn with
# no other unit beside it: rows narrower than a 128-byte line read at 41-80% of the rate of
# whole rows on an H100 (scripts/norm_bwd_ab.py --rows; PERF.md, PR 17).
_BWD_ROW_BYTES = 128
# The persistent path walks the instances in groups that its stash (a block's spare shared
# memory) and this many bytes of L2 hold together, so that the normalize pass reads little
# of x from memory again. At the two widest sites this and every instance at once ran
# within 1.5% of each other (scripts/norm_l2_budget.py; PERF.md, PR 8); this keeps one
# 42.5 MB SwinUNETR instance a group.
_L2_BUDGET = 24 << 20
# The H100's SMs and a block's shared memory (bytes), for a plan made without a card.
H100 = (132, 232448)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_floats(threads: int, vec: int, group: int) -> int:
    """The block's float scratch past the on-chip slab (csrc/instance_norm.cu Scratch)."""
    return 2 * threads * vec + 2 * max(threads, group) + 6 * group


def _layout(group: int, vec: int) -> tuple[int, int]:
    """(phases a unit row, threads a block): the threads a multiple of the phases."""
    gv = group // vec if group % vec == 0 else 1
    return gv, gv * max(1, _MAX_THREADS // gv)


# Registers a thread, by (path code, 16-byte vectors), for a plan made without a card:
# the persistent kernels' (ptxas gives 80-128 for the forward's 16-byte instances, 160-187
# for the backward's, 96 for its general one); 64 for the others (ptxas gives 40-64).
_MODEL_REGS = {(_PATHS["persistent"], True): 128, (_BWD_PATHS["persistent"], True): 168,
               (_BWD_PATHS["persistent"], False): 96}


def _model_occupancy(dtype: int, path: int, vec: int, threads: int, smem: int) -> int:
    """Blocks an H100 SM holds, for a plan made without a card: 65536 registers
    (``_MODEL_REGS`` a thread), and 228 KB of shared memory, 1 KB of it reserved a block."""
    regs = _MODEL_REGS.get((path, vec > 1), 64)
    return max(1, min(65536 // (regs * 32 * _cdiv(threads, 32)), 233472 // (smem + 1024)))


def _vectors(channels: int, spatial: int, dtype: torch.dtype, aligned: bool) -> tuple[int, int, list[int]]:
    """(bytes an element, elements a load, the channel groups a unit may take): 16-byte
    loads where a vector's channels stay fixed (C a multiple of the vector) or a vector holds
    whole voxels (C divides it), else one element."""
    elem = torch.empty((), dtype=dtype).element_size()
    vfull = 16 // elem
    packed = channels < vfull and vfull % channels == 0 and (spatial * channels) % vfull == 0
    vec = vfull if aligned and (channels % vfull == 0 or packed) else 1
    if packed and vec > 1:
        return elem, vec, [channels]
    divisors = [d for d in range(1, channels + 1) if channels % d == 0]
    return elem, vec, [g for g in divisors if g % vec == 0 and g // vec <= _MAX_THREADS]


@functools.lru_cache(maxsize=None)
def instance_norm_plan(batch: int, channels: int, spatial: int, dtype: torch.dtype, aligned: bool = True,
                       card: tuple[int, int] = H100, occupancy=_model_occupancy) -> dict:
    """What ``instance_norm_prelu`` launches for x (batch, channels, *spatial) with
    ``spatial`` voxels an instance, without launching it. ``aligned``: x's data pointer
    is 16-byte aligned. ``card``: (SMs, a block's shared memory in bytes);
    ``occupancy(dtype code, path code, vec, threads, smem)``: the blocks of that kernel an
    SM holds (the wrapper asks the card; by default a model of the H100).

    Returns a dict: ``path`` ("onchip": one block a unit, its slab in shared memory;
    "persistent": one cooperative grid over the card; "general": the persistent kernel
    with one element a load, for a C that no 16-byte vector fits or an unaligned x);
    ``vec`` the elements a load and ``vec_bytes``; ``group`` the channels a unit
    (``groups`` of them an instance; a unit is one instance's slab of ``group``
    channels); ``phases`` the vectors a unit row; ``threads`` and ``blocks``; for the
    persistent grid ``per_unit`` blocks a unit, ``units_per_group`` units at once and
    ``unit_groups`` groups walked in turn, and ``stash`` the vectors a thread keeps in
    shared memory from the sums to the normalize pass; ``smem`` the dynamic shared memory
    in bytes and ``scratch`` the float32 elements of the barrier and the partial sums."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"instance_norm_plan takes float32, bfloat16 or float16; got {dtype}")
    sms, smem_limit = card
    elem, vec, groups = _vectors(channels, spatial, dtype, aligned)

    def units(g: int) -> int:
        return batch * (channels // g)

    def plan(path: str, group: int, threads: int, blocks: int, smem: int, per_unit: int = 1, upg: int = 1,
             scratch: int = 0, stash: int = 0) -> dict:
        return {"path": path, "vec": vec, "vec_bytes": vec * elem, "group": group, "groups": channels // group,
                "phases": _layout(group, vec)[0], "threads": threads, "blocks": blocks, "per_unit": per_unit,
                "units_per_group": upg, "unit_groups": _cdiv(units(group), upg), "stash": stash, "smem": smem,
                "scratch": scratch}

    if vec > 1:  # on chip: the most channels a unit that still gives every SM a block, else the fewest
        fits = []
        for g in groups:
            if g * elem < _MIN_ROW_BYTES and g != channels:
                continue
            gv, threads = _layout(g, vec)
            smem = spatial * g * elem + 4 * _smem_floats(threads, vec, g)
            if (spatial * g) % vec == 0 and smem <= smem_limit:
                fits.append((g, threads, smem))
        if fits:
            wide = [f for f in fits if units(f[0]) >= sms]
            g, threads, smem = wide[-1] if wide else fits[0]
            return plan("onchip", g, threads, units(g), smem)
    g = groups[-1]
    gv, threads = _layout(g, vec)
    base = 16 * _cdiv(_smem_floats(threads, vec, g), 4)  # the scratch, to a 16-byte boundary
    code = _DTYPE_CODES[dtype], _PATHS["persistent"], vec, threads
    per_sm = occupancy(*code, base)
    # the stash: the shared memory that a block may take without lowering per_sm, 16 bytes
    # a thread an iteration (16-byte loads only)
    room = min((smem_limit + 1024) // per_sm - 1024, smem_limit) - base
    stash = room // (threads * 16) if vec > 1 else 0
    grid = sms * per_sm
    n_units, nvec = units(g), spatial * g // vec
    # as many units at once as the stash and the L2 budget hold, and the grid allows,
    # spread evenly over the groups
    hold = grid * stash * threads * 16 + _L2_BUDGET
    upg = max(1, min(n_units, grid, hold // max(1, spatial * g * elem)))
    upg = _cdiv(n_units, _cdiv(n_units, upg))
    per_unit = max(1, min(grid // upg, _cdiv(nvec, threads)))
    stash = min(stash, _cdiv(nvec, per_unit * threads))
    smem = base + stash * threads * 16
    if occupancy(*code, smem) < per_sm:
        raise RuntimeError(f"instance_norm_plan: {smem} B of shared memory lowers the occupancy below {per_sm}")
    return plan("persistent" if vec > 1 else "general", g, threads, per_unit * upg, smem, per_unit, upg,
                2 + 2 * n_units * per_unit * g, stash)


def _bwd_smem_floats(threads: int, vec: int, group: int) -> int:
    """The backward block's float scratch past its slabs (csrc/instance_norm.cu BwdScratch)."""
    return 3 * threads * vec + 3 * max(threads, group) + 8 * group


@functools.lru_cache(maxsize=None)
def instance_norm_backward_plan(batch: int, channels: int, spatial: int, dtype: torch.dtype, aligned: bool = True,
                                card: tuple[int, int] = H100, occupancy=_model_occupancy,
                                group: int | None = None) -> dict:
    """What ``instance_norm_prelu_backward`` launches for x and g (batch, channels,
    *spatial), one launch whatever the shape; arguments as ``instance_norm_plan``'s, and
    ``group`` forces the channels a unit (it must be one the vectors allow).

    The kernel is bound by its bytes, and dx needs the sums over a whole unit (one
    instance's slab of ``group`` channels), so the plan keeps x and g on chip from the
    sums to dx where it can. ``path`` "onchip": where a unit's x and g slabs both fit a
    block's shared memory, one block a unit (the most channels that still give every SM a
    block, else the fewest), x and g read once. Else "persistent" ("general" for a C that
    no 16-byte vector fits or an unaligned x or g: one element a load, no stash): one
    cooperative grid of ``per_sm`` blocks an SM, ``per_unit`` blocks a unit and
    ``units_per_group`` units at once; each thread keeps its first ``stash`` vectors of x
    and of g in shared memory (what a block may take without lowering ``per_sm``), and
    reads the rest again, the part that L2 still holds first. The unit is the widest channel
    group whose x and g (``unit_bytes``) the stash over the grid and the L2 budget hold
    (``held_bytes``), of those whose rows span a 128-byte line (or all the channels); else
    the narrowest such group: narrower rows read at 41-80% of the rate of whole rows, which
    costs more than reading x and g twice (PERF.md, PR 17). At (4, 48, 96³) no group fits,
    and a unit is a whole instance, 340 MB of x and g in float32. Also ``vec``,
    ``vec_bytes``, ``groups``, ``phases``, ``threads``, ``blocks``, ``unit_groups``,
    ``launches`` (1), ``stash_bytes`` (a block's), ``group_bytes`` (x and g of a group's
    units), ``smem`` in bytes and ``scratch``, the float32 elements of the barrier and
    the three partial sums."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"instance_norm_backward_plan takes float32, bfloat16 or float16; got {dtype}")
    sms, smem_limit = card
    elem, vec, groups = _vectors(channels, spatial, dtype, aligned)
    rows = [g for g in groups if g * elem >= _MIN_ROW_BYTES or g == channels]
    if group is not None:
        if group not in groups:
            raise ValueError(f"instance_norm_backward_plan: no unit of {group} channels at C={channels}, vec {vec}")
        rows = [group]

    def units(g: int) -> int:
        return batch * (channels // g)

    def plan(path: str, g: int, threads: int, smem: int, per_sm: int = 1, per_unit: int = 1, upg: int = 1,
             stash: int = 0, held: int = 0) -> dict:
        unit_bytes = 2 * spatial * g * elem
        return {"path": path, "launches": 1, "vec": vec, "vec_bytes": vec * elem, "group": g,
                "groups": channels // g, "phases": _layout(g, vec)[0], "threads": threads,
                "blocks": per_unit * upg, "per_sm": per_sm, "per_unit": per_unit,
                "units_per_group": upg, "unit_groups": _cdiv(units(g), upg), "stash": stash,
                "stash_bytes": 32 * stash * threads, "unit_bytes": unit_bytes, "group_bytes": upg * unit_bytes,
                "held_bytes": held, "smem": smem, "scratch": 0 if path == "onchip" else 2 + 3 * units(g) * per_unit * g}

    if vec > 1:
        fits = []
        for g in rows:
            _, threads = _layout(g, vec)
            smem = 2 * spatial * g * elem + 16 * _cdiv(_bwd_smem_floats(threads, vec, g), 4)
            if (spatial * g) % vec == 0 and smem <= smem_limit:
                fits.append((g, threads, smem))
        if fits:
            wide = [f for f in fits if units(f[0]) >= sms]
            g, threads, smem = wide[-1] if wide else fits[0]
            return plan("onchip", g, threads, smem, upg=units(g), held=2 * spatial * g * elem)
    code = _DTYPE_CODES[dtype], _BWD_PATHS["persistent"], vec

    def persistent(g: int) -> dict:
        _, threads = _layout(g, vec)
        base = 16 * _cdiv(_bwd_smem_floats(threads, vec, g), 4)  # the scratch, to a 16-byte boundary
        per_sm = occupancy(*code, threads, base)
        # the stash: the shared memory that a block may take without lowering per_sm, 32
        # bytes a thread an iteration (a vector of x and one of g; 16-byte loads only)
        room = min((smem_limit + 1024) // per_sm - 1024, smem_limit) - base
        stash = room // (threads * 32) if vec > 1 else 0
        grid = sms * per_sm
        held = grid * stash * threads * 32 + _L2_BUDGET
        n_units, nvec = units(g), spatial * g // vec
        # as many units at once as the stash and the L2 budget hold, and the grid allows,
        # spread evenly over the groups
        upg = max(1, min(n_units, grid, held // (2 * spatial * g * elem)))
        upg = _cdiv(n_units, _cdiv(n_units, upg))
        per_unit = max(1, min(grid // upg, _cdiv(nvec, threads)))
        stash = min(stash, _cdiv(nvec, per_unit * threads))
        return plan("persistent" if vec > 1 else "general", g, threads, base + stash * threads * 32, per_sm,
                    per_unit, upg, stash, held)

    options = [persistent(g) for g in rows if g * elem >= _BWD_ROW_BYTES or g == channels or g == rows[-1]]
    held = [o for o in options if o["unit_bytes"] <= o["held_bytes"]]
    p = held[-1] if held else options[0]
    if occupancy(*code, p["threads"], p["smem"]) < p["per_sm"]:
        raise RuntimeError(f"instance_norm_backward_plan: {p['smem']} B of shared memory lowers the occupancy below "
                           f"{p['per_sm']} (plan {p})")
    return p


@functools.cache
def _launcher():
    from ...ops._build import library

    fn = library().monai_instance_norm
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_launcher():
    from ...ops._build import library

    fn = library().monai_instance_norm_backward
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _occupancy_fn(device_index: int):
    """occupancy(dtype code, path code, vec, threads, smem) of the card's own kernels, cached."""
    from ...ops._build import library

    fn = library().monai_instance_norm_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    @functools.cache
    def occupancy(dtype: int, path: int, vec: int, threads: int, smem: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            err = fn(dtype, path, vec, threads, smem, ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"instance_norm: no occupancy for {threads} threads and {smem} B (error {err})")
        return out.value

    return occupancy


@functools.cache
def _card(device_index: int) -> tuple[tuple[int, int], object]:
    props = torch.cuda.get_device_properties(device_index)
    smem = getattr(props, "shared_memory_per_block_optin", H100[1])
    return (props.multi_processor_count, smem), _occupancy_fn(device_index)


def _plain_forward(x, weight, bias, slope, eps) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): the plain forward and its (2, B, C) float32 mean and rsqrt(var + eps)."""
    dims = tuple(range(2, x.ndim))
    n = math.prod(x.shape[2:])
    shape = (1, -1) + (1,) * (x.ndim - 2)
    xf = x.float()
    m = xf.sum(dims, keepdim=True) / n
    v = ((xf * xf).sum(dims, keepdim=True) / n - m * m).clamp_min(0.0)
    r = torch.rsqrt(v + eps)
    scale = r
    if weight is not None:
        scale = scale * weight.float().view(shape)
    y = (xf - m) * scale
    if bias is not None:
        y = y + bias.float().view(shape)
    if slope is not None:
        y = torch.where(y >= 0, y, y * _slope_view(slope, x.ndim))
    return y.to(x.dtype), torch.stack((m.reshape(x.shape[:2]), r.reshape(x.shape[:2])))


def _slope_view(slope: torch.Tensor, ndim: int) -> torch.Tensor:
    return slope.float().view((1, -1) + (1,) * (ndim - 2)) if slope.numel() > 1 else slope.float().reshape(())


def instance_norm_prelu_plain(x: torch.Tensor, weight: torch.Tensor | None = None,
                              bias: torch.Tensor | None = None, slope: torch.Tensor | None = None,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain-PyTorch version, with the same two-moment f32 statistics."""
    return _plain_forward(x, weight, bias, slope, eps)[0]


def instance_norm_prelu_backward_plain(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                                       weight: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                                       slope: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of ``instance_norm_prelu_backward``: the formula written out
    in float32."""
    dims = tuple(range(2, x.ndim))
    n = math.prod(x.shape[2:])
    shape = (1, -1) + (1,) * (x.ndim - 2)
    m, r = (t.reshape(*x.shape[:2], *(1,) * (x.ndim - 2)) for t in stats)
    scale = r if weight is None else r * weight.float().view(shape)
    xf, gf = x.float(), g.float()
    z = (xf - m) * scale
    if bias is not None:
        z = z + bias.float().view(shape)
    xh = (xf - m) * r
    gz = gf
    s3 = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    if slope is not None:
        neg = z < 0
        gz = torch.where(neg, gf * _slope_view(slope, x.ndim), gf)
        s3 = torch.where(neg, gf * z, 0.0).sum(dims)
    s1, s2 = gz.sum(dims), (gz * xh).sum(dims)
    dx = scale * (gz - s1.view(m.shape) / n - xh * (s2.view(m.shape) / n))
    return dx.to(x.dtype), torch.stack((s1, s2, s3))


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


@functools.lru_cache(maxsize=1024)
def _launch_args(shape: tuple[int, ...], dtype: torch.dtype, index: int, aligned: bool) -> tuple[dict, object]:
    """The plan of a launch, and the C function's plan array (B, S, C, dtype code, path
    code, vec, group, threads, blocks, per_unit, units_per_group, smem, stash)."""
    card, occupancy = _card(index)
    bsz, c, s = shape[0], shape[1], math.prod(shape[2:])
    p = instance_norm_plan(bsz, c, s, dtype, aligned, card, occupancy)
    return p, (ctypes.c_longlong * 13)(bsz, s, c, _DTYPE_CODES[dtype], _PATHS[p["path"]], p["vec"], p["group"],
                                       p["threads"], p["blocks"], p["per_unit"], p["units_per_group"], p["smem"],
                                       p["stash"])


_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _scratch(n: int, index: int, stream: int) -> torch.Tensor:
    """At least n float32 of the persistent grids' scratch (the forward's and the
    backward's) for launches in ``stream``, kept from call to call: its launches run in
    turn, and each leaves the barrier's words (the first two) as the next one needs them,
    so it is zeroed only when made."""
    buf = _SCRATCH.get((index, stream))
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[index, stream] = torch.zeros(n, dtype=torch.float32, device=torch.device("cuda", index))
    return buf


def _is_channels_last(x: torch.Tensor) -> bool:
    last = _CHANNELS_LAST.get(x.ndim)
    return x.is_contiguous(memory_format=last) if last else x.permute(0, *range(2, x.ndim), 1).is_contiguous()


def _check_card(x: torch.Tensor, weight, bias, slope, name: str = "instance_norm_prelu") -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {x.device}")
    if not _is_channels_last(x):
        raise ValueError(f"{name} takes a channels-last CUDA tensor "
                         "(x.contiguous(memory_format=torch.channels_last_3d))")
    for t in (weight, bias, slope):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous parameters")
        if t is not None and t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} takes float32, bfloat16 or float16 parameters on the card")


def _param_codes(weight, bias, slope) -> int:
    codes = 0 if slope is None else slope.numel() << 6 | _DTYPE_CODES[slope.dtype] << 4
    if weight is not None:
        codes |= _DTYPE_CODES[weight.dtype] | _DTYPE_CODES[bias.dtype] << 2
    return codes


def _call(fn, index: int, args) -> int:
    if index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def instance_norm_prelu(x: torch.Tensor, weight: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                        slope: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the spatial axes of ``x`` (B, C, *spatial), with optional affine
    ``weight``/``bias`` (C,) and optional PReLU ``slope`` (1,) or (C,); output in x's dtype.

    A CUDA ``x`` must be channels-last in memory (``x.permute(0, 2, ..., 1)`` contiguous,
    as ``torch.channels_last_3d`` gives); the CUDA kernel runs (``instance_norm_plan``
    says how) and ``instance_norm_prelu.launches`` goes up by one. A CPU ``x`` runs the
    plain version. Under autograd the backward runs ``instance_norm_prelu_backward``."""
    _check(x, weight, bias, slope)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias, slope)):
        return _InstanceNormPReLU.apply(x, weight, bias, slope, eps)
    return _forward(x, weight, bias, slope, eps, False)[0]


def _forward(x, weight, bias, slope, eps: float, want_stats: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(y, the (2, B, C) float32 statistics where asked for, else None)."""
    device = x.device
    if device.type == "cpu":
        y, stats = _plain_forward(x, weight, bias, slope, eps)
        return y, stats if want_stats else None
    _check_card(x, weight, bias, slope)
    out = torch.empty_like(x)  # x's strides: channels-last, (B, *spatial, C) in memory
    stats = torch.empty((2, *x.shape[:2]), dtype=torch.float32, device=device) if want_stats else None
    if x.numel() == 0:
        return out, stats
    index = device.index
    x_ptr = x.data_ptr()
    p, plan = _launch_args(tuple(x.shape), x.dtype, index, x_ptr % 16 == 0)
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch = _scratch(p["scratch"], index, stream).data_ptr() if p["scratch"] else None
    args = (x_ptr, out.data_ptr(), None if weight is None else weight.data_ptr(),
            None if bias is None else bias.data_ptr(), None if slope is None else slope.data_ptr(), scratch,
            None if stats is None else stats.data_ptr(), ctypes.addressof(plan), float(eps),
            _param_codes(weight, bias, slope), stream)
    err = _call(_launcher(), index, args)
    if err != 0:
        raise RuntimeError(f"instance_norm_prelu: CUDA launch failed with error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, plan {p})")
    count_launch(instance_norm_prelu)
    return out, stats


instance_norm_prelu.launches = 0


@functools.lru_cache(maxsize=1024)
def _backward_args(shape: tuple[int, ...], dtype: torch.dtype, index: int, aligned: bool) -> tuple[dict, object]:
    """The backward's plan, and the C function's plan array (B, S, C, dtype code, path
    code (0 on chip, 1 persistent), vec, group, threads, blocks, per_unit,
    units_per_group, smem, stash)."""
    card, occupancy = _card(index)
    bsz, c, s = shape[0], shape[1], math.prod(shape[2:])
    p = instance_norm_backward_plan(bsz, c, s, dtype, aligned, card, occupancy)
    return p, (ctypes.c_longlong * 13)(bsz, s, c, _DTYPE_CODES[dtype], int(p["path"] != "onchip"), p["vec"],
                                       p["group"], p["threads"], p["blocks"], p["per_unit"], p["units_per_group"],
                                       p["smem"], p["stash"])


def instance_norm_prelu_backward(g: torch.Tensor, x: torch.Tensor, stats: torch.Tensor,
                                 weight: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                                 slope: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``instance_norm_prelu`` for the grad ``g`` of its output on ``x``
    (both (B, C, *spatial), of one type), from the forward's ``stats`` ((2, B, C) float32
    mean and rsqrt(var + eps)): (dx in x's type, the (3, B, C) float32 sums of gz, gz x^
    and g z [z < 0] over the space), gz = g (z >= 0 ? 1 : slope). The grads of the bias,
    weight and slope are the sums over B (and over C for one slope) of the three.

    CUDA tensors must be channels-last in memory; the kernel runs
    (``instance_norm_backward_plan`` says how) and
    ``instance_norm_prelu_backward.launches`` goes up by one. CPU tensors run the plain
    version."""
    _check(x, weight, bias, slope)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x: {tuple(g.shape)} {g.dtype} against {tuple(x.shape)} {x.dtype}")
    if stats.shape != (2, *x.shape[:2]) or stats.dtype != torch.float32 or stats.device != x.device:
        raise ValueError(f"stats must be (2, B, C) float32 on x's device; got {tuple(stats.shape)} {stats.dtype}")
    if x.device.type == "cpu":
        return instance_norm_prelu_backward_plain(g, x, stats, weight, bias, slope)
    _check_card(x, weight, bias, slope, "instance_norm_prelu_backward")
    if not _is_channels_last(g) or not stats.is_contiguous():
        raise ValueError("instance_norm_prelu_backward takes a channels-last g and contiguous stats")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros((3, *x.shape[:2]), dtype=torch.float32, device=x.device)
    sums = torch.empty((3, *x.shape[:2]), dtype=torch.float32, device=x.device)  # the kernel writes each
    index = x.device.index
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    p, plan = _backward_args(tuple(x.shape), x.dtype, index, aligned)
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch = _scratch(p["scratch"], index, stream).data_ptr() if p["scratch"] else None
    args = (x.data_ptr(), g.data_ptr(), dx.data_ptr(), stats.data_ptr(),
            None if weight is None else weight.data_ptr(), None if bias is None else bias.data_ptr(),
            None if slope is None else slope.data_ptr(), scratch, sums.data_ptr(), ctypes.addressof(plan),
            _param_codes(weight, bias, slope), stream)
    err = _call(_backward_launcher(), index, args)
    if err != 0:
        raise RuntimeError(f"instance_norm_prelu_backward: CUDA launch failed with error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, plan {p})")
    count_launch(instance_norm_prelu_backward)
    return dx, sums


instance_norm_prelu_backward.launches = 0


class _InstanceNormPReLU(torch.autograd.Function):
    """The forward kernel with its statistics saved beside x; the backward kernel."""

    copied_bytes = 0  # grads that came back channel-first and were copied to channels-last, in bytes

    @staticmethod
    def forward(ctx, x, weight, bias, slope, eps):
        y, stats = _forward(x, weight, bias, slope, eps, True)
        ctx.save_for_backward(x, weight, bias, slope, stats)
        return y

    @staticmethod
    @once_differentiable  # the backward kernels have no backward of their own
    def backward(ctx, g):
        x, weight, bias, slope, stats = ctx.saved_tensors
        if x.device.type == "cuda" and not _is_channels_last(g):
            _InstanceNormPReLU.copied_bytes += g.numel() * g.element_size()
            g = channels_last(g)
        dx, sums = instance_norm_prelu_backward(g, x, stats, weight, bias, slope)
        dw = None if weight is None else sums[1].sum(0).to(weight.dtype)
        db = None if bias is None else sums[0].sum(0).to(bias.dtype)
        da = None
        if slope is not None:
            da = (sums[2].sum() if slope.numel() == 1 else sums[2].sum(0)).reshape(slope.shape).to(slope.dtype)
        return dx, dw, db, da, None


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
