"""Separable (diagonal-affine) resample of a channel-first (C, Z, Y, X) float32 volume on
a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_resample.py::pallas_separable_resample_3d. Each
axis's ``interp_matrix`` goes to the kernel as a tap table (``interp_taps``): per output
row, the row's nonzero input indices and weights, padded with weight 0 (at most 1, 2 or 4
taps for orders 0, 1 and 3). The kernel is ``csrc/separable_resample_3d.cu``; its header
says what bounds it on the card and what the design does about that. ``resample_plan``
says how a shape runs there, on the CPU too: the route ("fused": one launch, a block an
output tile, its input brick in shared memory, every axis contracted on chip; "axes": one
launch an axis, for the shapes whose brick does not fit), the tile, the bands, the order
in which the axes are contracted and the bytes each route moves.
``separable_resample_3d_plain`` is the dense three-``tensordot`` form of
``ops/separable.py::separable_affine_resample``: the wrapper runs it for tensors on the
CPU, and it is the oracle the kernel is held to on the card. For a CUDA tensor the
wrapper launches the kernel or raises; it never falls back. Forward only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from collections.abc import Sequence

import numpy as np
import torch

from ._build import library
from .separable import interp_matrix, is_separable, separable_affine_resample
from ..utils.counters import count_launch

__all__ = ["ResamplePlan", "interp_taps", "resample_plan", "separable_resample_3d", "separable_resample_3d_plain",
           "taps_from_matrix"]

ORDERS = (0, 1, 3)
BOUNDS = ("zeros", "border", "reflection")
TAPS = {0: 1, 1: 2, 3: 4}  # tap columns a row, per order: every table is padded to this width
THREADS = 256  # a block of the fused kernel (kThreads in the source)
# The fused route's output tiles: a run of 32-256 along the contiguous axis 3, a few rows
# on axes 1 and 2. A warp contracts a row at a time, its lanes along x, so the plan takes
# the longest run first (the whole axis up to 256): a row of 90 keeps 94% of the lanes
# busy, one of 16 half.
TILE_Z, TILE_Y, TILE_X = (1, 2, 4, 8, 16), (1, 2, 4, 8, 16, 32), (32, 64, 128, 256)
# Shared memory a fused block may take: 48 KB keeps four blocks of 256 threads on an SM
# (as many as their registers allow), so that some copy their bricks while others
# contract theirs. A shape with no tile under it takes the axes route.
FUSED_SMEM = 48 * 1024
SMEM_MAX = 232448  # what one block of the H100 can have


def taps_from_matrix(W: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n_out, T) int32 input indices and float32 weights of the nonzeros of each row of
    ``W``, in ascending index order, T the most any row has (at least 1); short rows are
    padded with their first index (0 for an empty row) and weight 0, so adding the
    weights at the indices rebuilds ``W`` exactly."""
    nz = W != 0
    taps = max(1, int(nz.sum(axis=1).max(initial=0)))
    rank = np.cumsum(nz, axis=1) - 1  # position of each nonzero within its row
    idx = np.zeros((W.shape[0], taps), dtype=np.int32)
    w = np.zeros((W.shape[0], taps), dtype=np.float32)
    rows, cols = np.nonzero(nz)
    idx[rows, rank[rows, cols]] = cols
    w[rows, rank[rows, cols]] = W[rows, cols]
    counts = nz.sum(axis=1)
    for t in range(1, taps):
        short = counts <= t
        idx[short, t] = idx[short, 0]
    return idx, w


@functools.lru_cache(maxsize=512)
def interp_taps(n_in: int, n_out: int, scale: float, offset: float, order: int, bound: str,
                align_corners: bool = False) -> tuple[np.ndarray, np.ndarray] | None:
    """The tap table of ``interp_matrix(...)``, or None where that matrix is the identity."""
    W = interp_matrix(n_in, n_out, scale, offset, order, bound, align_corners)
    if n_in == n_out and np.array_equal(W, np.eye(n_in, dtype=np.float32)):
        return None
    idx, w = taps_from_matrix(W)
    idx.flags.writeable = w.flags.writeable = False
    return idx, w


@dataclasses.dataclass(frozen=True, eq=False)
class ResamplePlan:
    """How ``separable_resample_3d`` runs a shape on the card (``resample_plan``).

    Axes are numbered 0, 1, 2 for Z, Y, X (the tensor's axes 1, 2, 3). ``identity`` marks
    the axes whose matrix is the identity: no kernel contracts them. ``order`` lists the
    other axes in the order the kernel contracts them. ``idx`` and ``w`` hold each
    contracted axis's tap table, (n_out, taps) int32 and float32, padded with weight 0
    (None for an identity axis): on the fused route each index counts from the band start
    of its row's tile, on the axes route from 0.

    The fused route: one launch; a block owns a ``tile`` (z, y, x) of the output of one
    channel, ``tiles`` of them along each axis, and copies its input ``band`` (z, y, x),
    starting at ``starts[a][t]`` on axis a for tile t (tile origins on an identity axis),
    into shared memory, ``vec`` floats a copy along x; it contracts the brick axis by axis
    in ``order`` and writes the tile. ``offsets`` (in floats): the first and second
    contraction's outputs (-1: over the brick) and the block's tap rows; ``smem`` the
    dynamic shared memory in bytes. The axes route: one launch an axis in ``order``,
    through two float32 volumes of ``tmp`` elements each (0 where not needed).

    ``bytes_fused`` counts what the fused route moves (every block's brick, overlaps
    included, and the output; None where no tile fits), ``bytes_axes`` what the axes
    route moves (each pass's input and output), and ``bytes_bound`` the input read once
    and the output written once."""
    route: str
    in_shape: tuple[int, int, int, int]
    out_shape: tuple[int, int, int]
    taps: int
    identity: tuple[bool, bool, bool]
    order: tuple[int, ...]
    idx: tuple[np.ndarray | None, ...]
    w: tuple[np.ndarray | None, ...]
    tile: tuple[int, int, int]
    tiles: tuple[int, int, int]
    band: tuple[int, int, int]
    starts: tuple[np.ndarray, ...]
    vec: int
    offsets: tuple[int, int, int]
    smem: int
    tmp: tuple[int, int]
    bytes_fused: int | None
    bytes_axes: int
    bytes_bound: int

    @property
    def launches(self) -> int:
        """CUDA launches a call makes."""
        return 1 if self.route == "fused" else len(self.order)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _nonzero_span(W: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per row of W: whether it has a nonzero, its first and its last nonzero column."""
    nz = W != 0
    full = nz.any(axis=1)
    lo = np.argmax(nz, axis=1)
    hi = W.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
    return full, lo, hi


def _bands(W: np.ndarray, t: int, vec: int) -> tuple[np.ndarray, int]:
    """Per tile of t rows of W, the first input index of its band, and the static band
    length: the widest span of a tile's nonzeros, rows without any left out (as
    monai_tpu/ops/pallas_resample.py::_band_params leaves them out), the span's start
    rounded down to ``vec`` and its length up to it, clamped to the axis."""
    n_out, n_in = W.shape
    full, lo, hi = _nonzero_span(W)
    n_t = _cdiv(n_out, t)
    pad = n_t * t - n_out
    full_t = np.pad(full, (0, pad)).reshape(n_t, t)
    lo_t = np.where(full_t, np.pad(lo, (0, pad)).reshape(n_t, t), n_in).min(axis=1)
    hi_t = np.where(full_t, np.pad(hi, (0, pad)).reshape(n_t, t), -1).max(axis=1)
    some = full_t.any(axis=1)
    lo_t = np.where(some, lo_t - lo_t % vec, 0)
    span = int(np.max(np.where(some, hi_t - lo_t + 1, 1)))
    band = min(_cdiv(span, vec) * vec, n_in)
    return np.minimum(lo_t, n_in - band).astype(np.int32), band


def _padded(idx: np.ndarray, w: np.ndarray, taps: int) -> tuple[np.ndarray, np.ndarray]:
    """A tap table widened to ``taps`` columns by weight-0 copies of its first column."""
    extra = taps - idx.shape[1]
    return (np.concatenate([idx, np.repeat(idx[:, :1], extra, axis=1)], axis=1),
            np.concatenate([w, np.zeros((w.shape[0], extra), np.float32)], axis=1))


def _fused_layout(order: Sequence[int], band: Sequence[int], tile: Sequence[int], identity: Sequence[bool],
                  taps: int) -> tuple[tuple[int, int, int], int]:
    """Shared-memory offsets (floats) of the first and second contraction's outputs (-1:
    over the brick) and of the tap rows, and the bytes a block takes. The brick sits at
    0; the last contraction writes to device memory; the second one's output goes over
    the brick where it fits."""
    dims = list(band)
    sizes = []
    for a in order:
        dims[a] = tile[a]
        sizes.append(math.prod(dims))
    brick = math.prod(band)
    off1 = _cdiv(brick, 4) * 4
    end = max(brick, off1 + sizes[0] if len(order) >= 2 else 0)
    off2 = -1
    if len(order) == 3 and sizes[1] > brick:
        off2 = _cdiv(end, 4) * 4
        end = off2 + sizes[1]
    off_taps = _cdiv(end, 4) * 4
    n_taps = sum(2 * taps * tile[a] for a in range(3) if not identity[a])
    return (off1, off2, off_taps), 4 * (off_taps + n_taps)


def _order_cost(order: Sequence[int], dims: Sequence[int], final: Sequence[int]) -> tuple[int, int]:
    """(elements the contractions write, the largest) contracting ``order`` from ``dims``."""
    dims, written, largest = list(dims), 0, 0
    for a in order:
        dims[a] = final[a]
        n = math.prod(dims)
        written, largest = written + n, max(largest, n)
    return written, largest


def resample_plan(in_shape: Sequence[int], out_shape: Sequence[int], matrix: np.ndarray, order: int = 1,
                  bound: str = "zeros", align_corners: bool = False, vec: int | None = None,
                  tile: Sequence[int] | None = None) -> ResamplePlan:
    """How ``separable_resample_3d`` runs an input of ``in_shape`` ((C, Z, Y, X) or
    (Z, Y, X), then C = 1) to ``out_shape`` by the diagonal affine ``matrix``, without
    launching anything; pure Python and numpy, so it runs on the CPU too.

    ``vec`` is the floats a copy takes along x on the fused route (4, 2 or 1), by default
    the most that divides the input's x extent: the wrapper passes less when the tensor's
    address is not aligned to it. ``tile`` forces the fused route's output tile (to time
    another one); the plan picks it otherwise: among ``TILE_Z`` x ``TILE_Y`` x ``TILE_X``
    (each cut to the output's extent) whose block fits ``FUSED_SMEM``, the one with the
    longest run along x, then with an output a thread of the block, then whose bricks
    move the fewest bytes, then with the least shared memory. A shape with none takes the
    axes route. The axes are contracted in the order that writes the fewest elements on chip
    (fused) or moves the fewest bytes through device memory (axes). Plans are cached by
    their arguments: the same arguments return the same plan, not to be changed."""
    m = np.asarray(matrix, dtype=np.float64)
    shape = tuple(int(s) for s in in_shape)
    shape = (1, *shape) if len(shape) == 3 else shape
    diag = tuple((float(m[d, d]), float(m[d, 3])) for d in range(3))
    return _plan(shape, tuple(int(s) for s in out_shape), diag, int(order), str(bound), bool(align_corners),
                 None if vec is None else int(vec), None if tile is None else tuple(int(t) for t in tile))


@functools.lru_cache(maxsize=256)
def _plan(shape: tuple[int, ...], out: tuple[int, ...], diag: tuple, order: int, bound: str, align_corners: bool,
          vec: int | None, force_tile: tuple[int, ...] | None) -> ResamplePlan:
    if len(shape) != 4 or len(out) != 3 or min(shape) <= 0 or min(out) <= 0 or order not in ORDERS \
            or bound not in BOUNDS or vec not in (None, 1, 2, 4):
        raise ValueError(f"resample_plan takes a (C, Z, Y, X) or (Z, Y, X) input, 3 output sizes, orders {ORDERS}, "
                         f"bounds {BOUNDS} and vec 1, 2 or 4; got {shape}, {out}, {order}, {bound!r}, {vec}")
    c, n_in = shape[0], shape[1:]
    taps = TAPS[order]
    vec = max(v for v in (1, 2, 4) if n_in[2] % v == 0 and v <= (vec or 4))
    tables = [interp_taps(n_in[a], out[a], diag[a][0], diag[a][1], order, bound, align_corners) for a in range(3)]
    identity = tuple(t is None for t in tables)
    axes = [a for a in range(3) if not identity[a]]
    mats = [interp_matrix(n_in[a], out[a], diag[a][0], diag[a][1], order, bound, align_corners) for a in range(3)]
    bytes_bound = 4 * c * (math.prod(n_in) + math.prod(out))

    # the axes route: the order that moves the fewest bytes through the intermediates
    def moved(perm):
        dims, total, sizes = list(n_in), 0, []
        for a in perm:
            before = math.prod(dims)
            dims[a] = out[a]
            total += before + math.prod(dims)
            sizes.append(math.prod(dims))
        return 4 * c * total, sizes

    axes_order = min(itertools.permutations(axes), key=lambda p: (moved(p)[0], p))
    bytes_axes, sizes = moved(axes_order)
    tmp = (c * sizes[0] if len(sizes) >= 2 else 0, c * sizes[1] if len(sizes) == 3 else 0)

    # the fused route: every candidate tile, its bands, order and shared memory
    cand = [force_tile] if force_tile is not None else sorted({
        (min(tz, out[0]), min(ty, out[1]), min(tx, out[2])) for tz in TILE_Z for ty in TILE_Y for tx in TILE_X})
    limit = SMEM_MAX if force_tile is not None else FUSED_SMEM
    best, bands_cache = None, {}
    for t in cand:
        if len(t) != 3 or min(t) <= 0:
            raise ValueError(f"resample_plan: a tile is 3 positive sizes, not {t}")
        # on an identity x axis the brick's rows are the tile's, so the tile keeps them aligned
        tvec = max(v for v in (1, 2, 4) if v <= vec and (t[2] % v == 0 or not identity[2] or t[2] >= out[2]))
        bands = []
        for a in range(3):
            if identity[a]:
                bands.append((np.arange(0, out[a], t[a], dtype=np.int32), t[a]))
            else:
                key = (a, t[a], tvec if a == 2 else 1)
                if key not in bands_cache:
                    bands_cache[key] = _bands(mats[a], t[a], key[2])
                bands.append(bands_cache[key])
        band = tuple(b for _, b in bands)
        perm = min(itertools.permutations(axes), key=lambda p: (_order_cost(p, band, t), p))
        n_tiles = tuple(_cdiv(out[a], t[a]) for a in range(3))
        offsets, smem = _fused_layout(perm, band, t, identity, taps)
        if smem > limit or c * math.prod(n_tiles) >= 2 ** 31:  # a grid's x extent
            continue
        moved_fused = 4 * c * (math.prod(n_tiles) * math.prod(band) + math.prod(out))
        key = (-t[2], math.prod(t) < min(THREADS, math.prod(out)), moved_fused, -t[1], smem, t)
        if best is None or key < best[0]:
            best = (key, dict(tile=t, tiles=n_tiles, band=band, starts=tuple(s for s, _ in bands), vec=tvec,
                              order=perm, offsets=offsets, smem=smem, bytes_fused=moved_fused))

    idx, w = [None] * 3, [None] * 3
    if best is None:  # the axes route: absolute indices
        for a in axes:
            idx[a], w[a] = _padded(*tables[a], taps)
        return ResamplePlan("axes", shape, out, taps, identity, axes_order, tuple(idx), tuple(w), (0, 0, 0),
                            (0, 0, 0), (0, 0, 0), (), vec, (0, 0, 0), 0, tmp, None, bytes_axes, bytes_bound)
    f = best[1]
    for a in axes:
        i, wa = _padded(*tables[a], taps)
        row_start = np.repeat(f["starts"][a], f["tile"][a])[:out[a]]
        empty = ~(wa != 0).any(axis=1)
        i = np.where(empty[:, None], row_start[:, None], i) - row_start[:, None]  # empty rows point at the band
        idx[a], w[a] = i.astype(np.int32), wa
    return ResamplePlan("fused", shape, out, taps, identity, f["order"], tuple(idx), tuple(w), f["tile"], f["tiles"],
                        f["band"], f["starts"], f["vec"], f["offsets"], f["smem"], tmp, f["bytes_fused"], bytes_axes,
                        bytes_bound)


def separable_resample_3d_plain(img: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], order: int = 1,
                                bound: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Plain-PyTorch version: three dense float32 ``tensordot``s, axis 1, 2, then 3."""
    return separable_affine_resample(img, matrix, out_shape, order, bound, align_corners)


@functools.lru_cache(maxsize=256)
def _is_diagonal(m: bytes) -> bool:
    """``is_separable`` of the (4, 4) float64 affine whose bytes are ``m``, cached: a path
    checks the same few matrices call after call, and the check costs more host time than
    the kernel takes on the card."""
    return is_separable(np.frombuffer(m, dtype=np.float64).reshape(4, 4))


def _check(img: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], order: int, bound: str) -> None:
    if not isinstance(img, torch.Tensor) or img.ndim != 4:
        raise ValueError(f"separable_resample_3d takes a (C, Z, Y, X) tensor; got "
                         f"{tuple(img.shape) if isinstance(img, torch.Tensor) else type(img)}")
    if img.dtype != torch.float32:
        raise TypeError(f"separable_resample_3d takes float32; got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("separable_resample_3d takes a contiguous tensor")
    m = np.asarray(matrix, dtype=np.float64)
    if m.shape != (4, 4) or not _is_diagonal(m.tobytes()):
        raise ValueError(f"separable_resample_3d takes a diagonal (4, 4) affine; got {m.tolist()}")
    if len(out_shape) != 3 or any(int(s) <= 0 for s in out_shape) or min(img.shape) <= 0:
        raise ValueError(f"separable_resample_3d needs 3 positive output sizes and a non-empty input; got "
                         f"{tuple(out_shape)} from {tuple(img.shape)}")
    if order not in ORDERS or bound not in BOUNDS:
        raise ValueError(f"separable_resample_3d takes orders {ORDERS} and bounds {BOUNDS}; got {order}, {bound!r}")
    if torch.is_grad_enabled() and img.requires_grad:
        raise RuntimeError("separable_resample_3d is forward-only; run it under torch.inference_mode()")


@functools.cache
def _launcher():
    fn = library().monai_separable_resample_3d
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _launch_args(plan: ResamplePlan, device: torch.device) -> tuple[tuple[torch.Tensor, torch.Tensor], object]:
    """The plan's tables on ``device`` (kept there: a path resamples with the same tables
    volume after volume) and the C function's plan array: route, C, the input and output
    extents, taps, contractions, order, then tile, tiles, band, vec, offsets, smem, and a
    band-start, tap-index and tap-weight pointer per axis (0 for an identity axis)."""
    ints, floats, where = [], [], []
    for a in range(3):
        if plan.idx[a] is None:
            where.append(None)
            continue
        n_i = sum(x.size for x in ints)
        starts = plan.starts[a] if plan.route == "fused" else np.zeros(0, np.int32)
        ints += [starts, plan.idx[a].ravel()]
        where.append((n_i, n_i + starts.size, sum(x.size for x in floats)))
        floats.append(plan.w[a].ravel())
    i_dev = torch.from_numpy(np.concatenate(ints or [np.zeros(1, np.int32)])).to(device)
    f_dev = torch.from_numpy(np.concatenate(floats or [np.zeros(1, np.float32)])).to(device)
    ptrs = []
    for kind in range(3):  # starts, idx, w
        for a in range(3):
            if where[a] is None:
                ptrs.append(0)
            else:
                base = f_dev.data_ptr() if kind == 2 else i_dev.data_ptr()
                ptrs.append(base + 4 * where[a][kind])
    order = list(plan.order) + [-1] * (3 - len(plan.order))
    values = [0 if plan.route == "fused" else 1, *plan.in_shape, *plan.out_shape, plan.taps, len(plan.order), *order,
              *plan.tile, *plan.tiles, *plan.band, plan.vec, *plan.offsets, plan.smem, *ptrs]
    return (i_dev, f_dev), (ctypes.c_longlong * len(values))(*values)


def separable_resample_3d(img: torch.Tensor, matrix: np.ndarray, out_shape: Sequence[int], order: int = 1,
                          bound: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Resample contiguous float32 ``img`` (C, Z, Y, X) by a diagonal (4, 4) affine that
    maps output voxels to input voxels, to (C, *out_shape) float32; orders 0, 1 and 3,
    bounds zeros, border and reflection, as ``interp_matrix`` builds them.

    CPU tensors run the plain version; CUDA tensors run the CUDA kernel on the route
    ``resample_plan`` gives (one launch on the fused route, one an axis on the axes
    route), add one to ``separable_resample_3d.launches`` and the CUDA launches the C
    function reports to ``separable_resample_3d.cuda_launches``."""
    _check(img, matrix, out_shape, order, bound)
    if img.device.type == "cpu":
        return separable_resample_3d_plain(img, matrix, out_shape, order, bound, align_corners)
    if img.device.type != "cuda":
        raise ValueError(f"separable_resample_3d runs on CPU or CUDA tensors, not {img.device}")
    ptr = img.data_ptr()
    align = next(v for v in (4, 2, 1) if ptr % (4 * v) == 0)
    return _launch(img, resample_plan(img.shape, out_shape, matrix, order, bound, align_corners, vec=align))


def _launch(img: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """Run ``plan`` on the CUDA tensor ``img``, checked by the caller (``chip_smoke.py``
    times other tiles' plans through it), and count the launch."""
    ptr = img.data_ptr()
    _, args = _launch_args(plan, img.device)
    out = torch.empty((img.shape[0], *plan.out_shape), dtype=torch.float32, device=img.device)
    tmp = [torch.empty(n, dtype=torch.float32, device=img.device) if n else None for n in plan.tmp]
    launched = ctypes.c_int(0)
    index = img.device.index
    call = (ptr, out.data_ptr(), None if tmp[0] is None else tmp[0].data_ptr(),
            None if tmp[1] is None else tmp[1].data_ptr(), ctypes.addressof(args),
            torch._C._cuda_getCurrentRawStream(index), ctypes.byref(launched))
    if index == torch.cuda.current_device():
        err = _launcher()(*call)
    else:
        with torch.cuda.device(index):
            err = _launcher()(*call)
    if err != 0:
        raise RuntimeError(f"separable_resample_3d: CUDA launch failed with error {err} "
                           f"({tuple(img.shape)} -> {plan.out_shape}, route {plan.route}, tile {plan.tile})")
    count_launch(separable_resample_3d)
    count_launch(separable_resample_3d, launched.value, "cuda_launches")
    return out


separable_resample_3d.launches = 0
separable_resample_3d.cuda_launches = 0
