"""Brute-force bilateral filter of (B, C, *spatial) tensors on a CUDA kernel.

Counterpart of monai_tpu/ops/pallas_filtering.py::bilateral_filter_pallas (TPU kernels
``_run_2d`` and ``_run_3d``), which computes what the XLA stencil of
monai_tpu/ops/filtering.py::bilateral_filter computes: for every voxel, the weighted mean
of its edge-padded (2r+1)^sd neighbourhood, each neighbour weighted by a spatial Gaussian
of its offset times a range Gaussian of its difference to the centre, with
r = max(int(truncate * spatial_sigma + 0.5), 1). The kernels are in
``csrc/bilateral_filter.cu``; its header says what bounds them on the card and what the
design does about that. ``bilateral_plan`` says which kernel a shape and radius launch,
with its geometry and the exps it computes a voxel; it is pure Python and runs anywhere.
Every radius runs on the card. ``bilateral_stencil_plain`` is the stencil in PyTorch: the
tests hold it to the JAX package, and the card holds the kernels to it.
``bilateral_stencil`` takes CUDA tensors only and launches the kernel or raises;
``ops/filtering.py::bilateral_filter`` sends every other tensor to the plain version.
Forward only.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from collections.abc import Sequence

import numpy as np
import torch

from ._build import library
from ..utils.counters import count_launch

__all__ = ["bilateral_exps", "bilateral_plan", "bilateral_stencil", "bilateral_stencil_plain", "card_resident",
           "edge_pad", "filter_radius", "spatial_weights"]


def filter_radius(spatial_sigma: float, truncate: float = 2.0) -> int:
    """The stencil's radius, as the JAX package sets it."""
    return max(int(truncate * float(spatial_sigma) + 0.5), 1)


@functools.lru_cache(maxsize=64)
def spatial_weights(spatial_sigma: float, radius: int, sd: int) -> np.ndarray:
    """(2r+1)^sd float32 spatial weights exp(-|o|^2 * 0.5 / sigma^2), offsets in row-major
    order; each computed in float64 and rounded once, as the JAX stencil rounds its
    Python-float weight against a float32 array. Read-only."""
    w = np.array([math.exp(-0.5 * sum(o * o for o in off) / (spatial_sigma ** 2))
                  for off in itertools.product(range(-radius, radius + 1), repeat=sd)], dtype=np.float32)
    w.flags.writeable = False
    return w


def edge_pad(x: torch.Tensor, radii: Sequence[int]) -> torch.Tensor:
    """Pad the spatial axes of (B, C, *spatial) ``x`` by ``radii[d]`` on both sides with
    the edge value (``jnp.pad(mode="edge")``), for any number of axes and any size."""
    for d, r in enumerate(radii):
        n = x.shape[2 + d]
        idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
        x = x.index_select(2 + d, idx)
    return x


def bilateral_stencil_plain(img: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
                            truncate: float = 2.0) -> torch.Tensor:
    """The stencil in PyTorch, any number of spatial axes: the JAX package's loop over
    the offsets, in float32 (other float types are cast to it and back)."""
    x = img.float()
    sd = x.ndim - 2
    radius = filter_radius(spatial_sigma, truncate)
    padded = edge_pad(x, (radius,) * sd)
    spatial = x.shape[2:]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    w_s = spatial_weights(float(spatial_sigma), radius, sd)
    for t, off in enumerate(itertools.product(range(-radius, radius + 1), repeat=sd)):
        shifted = padded[(slice(None), slice(None)) + tuple(slice(radius + o, radius + o + s)
                                                            for o, s in zip(off, spatial))]
        w = torch.exp(-0.5 * ((shifted - x) / color_sigma) ** 2).mul_(float(w_s[t]))
        num.add_(w * shifted)
        den.add_(w)
    return (num / den.clamp_(min=1e-8)).to(img.dtype)


# The kernels' geometry, as csrc/bilateral_filter.cu fixes it. The pair kernels are
# compiled for each radius up to PAIR_RADIUS[sd]; a thread owns KX columns and KM rows of
# a slice (3-D) or row (2-D) and walks the slowest axis. 3-D blocks have 4 warps
# (warps_x * warps_y), 2-D blocks one. The run-time-radius ("tap") kernels keep blocks of
# 32 x 8 threads, 4 slices a thread in 3-D, and stage their tile in shared memory up to
# TAP_SHARED_BYTES.
PAIR_RADIUS = {2: 8, 3: 3}
KX, KM = {2: 6, 3: 1}, {2: 1, 3: 8}
PAIR_WARPS = {2: 1, 3: 4}
TAP_TILE, TAP_SHARED_BYTES = (4, 8, 32), 48 * 1024
# The segments of the walked axis are sized for MIN_WAVES waves of resident blocks or
# more. The threshold is fitted, not derived: in chip_smoke.py's segment sweep on the H100
# both stages ran about 16% slower than at the plan's segment at 1.06-1.33 waves, and
# within about 4.5% of it from 1.5 waves up (PERF.md §6); 2 keeps a margin from the
# first. H100_SMS is the default when no card is asked; the wrapper reads the card's
# count.
H100_SMS, MIN_WAVES = 132, 2.0
_INSTANCES = {"pair": 0, "tap-shared": 1, "tap-global": 2}


# Blocks of each pair instance that an H100 SM holds at once (3-D: 4 warps a block, 2-D:
# one), set by their registers (each of an SM's 4 quarters holds 16384 for its warps):
# what the CUDA runtime works out for this build (monai_bilateral_resident in
# csrc/bilateral_filter.cu), which the card tests hold this table to.
PAIR_RESIDENT = {3: {1: 4, 2: 3, 3: 3}, 2: {1: 20, 2: 16, 3: 16, 4: 16, 5: 16, 6: 8, 7: 8, 8: 8}}


def card_resident(device: torch.device, sd: int, radius: int, warps_x: int) -> int:
    """Blocks of the pair instance for (sd, radius), ``warps_x`` warps side by side, that an
    SM of the CUDA ``device`` holds at once, as the CUDA runtime works it out."""
    with torch.cuda.device(device):
        n = library().monai_bilateral_resident(sd, radius, warps_x)
    if n <= 0:
        raise RuntimeError(f"card_resident: no pair instance for sd {sd}, radius {radius}, warps_x {warps_x} "
                           f"(error {-n})")
    return n


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pair_exps(sd: int, r: int) -> list[int]:
    """Exps a lane computes in one step of a pair kernel, for each slowest-axis offset a
    in 0..r: one per pair (q, q + o), o lexicographically above 0 with a first, at every
    position of the lane's columns and rows where q or q + o is the lane's own voxel."""
    if sd == 2:
        return [KX[2] * (r if a == 0 else 2 * r + 1) for a in range(r + 1)]
    km = KM[3]
    return [sum(km + abs(b) for c in range(-r, r + 1) for b in range(-r, r + 1)
                if a > 0 or b > 0 or (b == 0 and c > 0)) for a in range(r + 1)]


def bilateral_plan(shape: Sequence[int], radius: int, sms: int = H100_SMS, seg: int | None = None) -> dict:
    """What ``bilateral_stencil`` launches for a (B, C, H, W) or (B, C, D, H, W) float32
    tensor of ``shape`` at ``radius``, without launching it, on a card of ``sms`` SMs (the
    H100's 132 by default). ``seg`` forces the pair kernels' segment length (to time
    another one); the plan picks it otherwise.

    Returns a dict: ``instance`` ("pair": the kernel compiled for this radius, one exp a
    symmetric pair of voxels; "tap-shared" or "tap-global": the run-time-radius kernel,
    one exp a tap, its taps from shared or global memory), with ``label`` naming it and
    the radius; ``taps`` T = (2r+1)^sd; ``least_exps`` (T - 1) / 2, the exps a voxel the
    function needs; ``exps`` those this geometry computes, every lane of every block
    counted (the halo lanes, rows and steps, and the lanes past the image's edge), which
    the kernel's checked build counts on the card (``bilateral_exps``), and
    ``exps_per_voxel`` them over the voxels. The geometry: ``kx``, ``km`` the columns and
    rows a thread owns, ``halo_lanes`` the lanes at each end of a warp that only feed their neighbours,
    ``cols_per_warp`` the columns a warp writes, ``warps_x``, ``warps_y``, ``threads``,
    ``seg`` the steps of the slowest axis a block walks (0 for the tap kernels),
    ``tiles`` (x, y, slowest), ``blocks``, ``smem`` in bytes, and for the pair kernels
    ``resident`` the blocks an SM holds at once and ``waves`` the busiest SM's blocks over
    them. Plans are cached by their arguments: the same arguments return the same dict,
    not to be changed."""
    return _plan(tuple(int(s) for s in shape), int(radius), int(sms), None if seg is None else int(seg))


@functools.lru_cache(maxsize=256)
def _plan(shape: tuple[int, ...], radius: int, sms: int, force_seg: int | None) -> dict:
    if len(shape) not in (4, 5) or min(shape) <= 0 or radius < 0 or sms <= 0 or (force_seg or 1) <= 0:
        raise ValueError(f"bilateral_plan takes a (B, C, H, W) or (B, C, D, H, W) shape, a radius >= 0, sms > 0 "
                         f"and seg > 0; got {shape}, {radius}, {sms}, {force_seg}")
    sd = len(shape) - 2
    planes = shape[0] * shape[1]
    d, h, w = (1, *shape[2:]) if sd == 2 else shape[2:]
    voxels = planes * d * h * w
    taps = (2 * radius + 1) ** sd
    base = {"taps": taps, "least_exps": (taps - 1) / 2, "radius": radius, "sd": sd}
    if 1 <= radius <= PAIR_RADIUS[sd]:
        r, kx, km = radius, KX[sd], KM[sd]
        halo = _cdiv(r, kx)
        ox = (32 - 2 * halo) * kx
        stream, rows = (h, 1) if sd == 2 else (d, h)  # the walked axis; the rows a slice has
        # 3-D: warps along x, the fewest columns covered, then the most; the rest along the rows
        wx = 1 if sd == 2 else min((1, 2, 4), key=lambda n: (_cdiv(w, n * ox) * n, -n))
        wy = PAIR_WARPS[sd] // wx
        tiles_x, tiles_y = _cdiv(w, wx * ox), _cdiv(rows, wy * km)
        per_a = _pair_exps(sd, r)
        full, halo_steps = sum(per_a), sum(sum(per_a[k:]) for k in range(1, r + 1))
        lanes = 32 * wx * wy
        resident = PAIR_RESIDENT[sd][r]

        def cost(nseg: int) -> tuple:
            """(fewer than MIN_WAVES waves of resident blocks, the busiest SM's lane-exps
            over the blocks it runs at once, nseg, seg, waves), each SM taking its share of
            equal blocks."""
            seg = _cdiv(stream, nseg)
            blocks = planes * tiles_x * tiles_y * _cdiv(stream, seg)
            waves = _cdiv(blocks, sms) / resident
            return waves < MIN_WAVES, max(waves, 1.0) * (seg * full + halo_steps), _cdiv(stream, seg), seg, waves

        if force_seg is not None:
            _, _, nseg, seg, waves = cost(_cdiv(stream, min(force_seg, stream)))
        else:
            # the slowest axis cut into segments of at least 4r steps (r halo steps a
            # segment): the cheapest cut with MIN_WAVES waves or more, if any
            most = max(1, stream // min(stream, 4 * r))
            _, _, nseg, seg, waves = min(cost(n) for n in range(1, min(most, 64) + 1))
        # every step of the walked axis runs once, and r halo steps a segment
        total = planes * tiles_x * tiles_y * lanes * (stream * full + nseg * halo_steps)
        ring = r + 2
        tw = wx * ox + 2 * (halo * kx + r)
        th = 1 if sd == 2 else wy * km + 2 * r
        return {**base, "instance": "pair", "label": f"pair-{sd}d-r{r}", "kx": kx, "km": km, "halo_lanes": halo,
                "cols_per_warp": ox, "warps_x": wx, "warps_y": wy, "threads": lanes, "seg": seg,
                "tiles": (tiles_x, tiles_y, nseg), "blocks": planes * tiles_x * tiles_y * nseg,
                "smem": 4 * ring * tw * th, "resident": resident, "waves": waves, "exps": total,
                "exps_per_voxel": total / voxels}
    tz, ty, tx = TAP_TILE
    tiles = (_cdiv(w, tx), _cdiv(h, ty), _cdiv(d, tz) if sd == 3 else 1)
    halo_z = tz + 2 * radius if sd == 3 else 1
    smem = 4 * halo_z * (ty + 2 * radius) * (tx + 2 * radius)
    instance = "tap-shared" if smem <= TAP_SHARED_BYTES else "tap-global"
    total = planes * tiles[0] * tx * tiles[1] * ty * d * (taps - 1)
    return {**base, "instance": instance, "label": f"{instance}-{sd}d", "kx": 1, "km": tz if sd == 3 else 1,
            "halo_lanes": 0, "cols_per_warp": 32, "warps_x": 1, "warps_y": ty, "threads": tx * ty, "seg": 0,
            "tiles": tiles, "blocks": planes * tiles[0] * tiles[1] * tiles[2],
            "smem": smem if instance == "tap-shared" else 0, "exps": total, "exps_per_voxel": total / voxels}


@functools.lru_cache(maxsize=64)
def _log2_spatial_weights(spatial_sigma: float, radius: int, sd: int) -> np.ndarray:
    """log2 of ``spatial_weights(...)``, entry by entry, in float64 rounded once to
    float32 (-inf where a weight is 0): the kernels add it to the range exponent, so a
    tap's weight is one exp2. Read-only."""
    with np.errstate(divide="ignore"):
        lw = np.log2(spatial_weights(spatial_sigma, radius, sd).astype(np.float64)).astype(np.float32)
    lw.flags.writeable = False
    return lw


@functools.lru_cache(maxsize=64)
def _device_log2_weights(spatial_sigma: float, radius: int, sd: int, device: torch.device) -> torch.Tensor:
    """``_log2_spatial_weights(...)`` on ``device``, kept there for the tap kernels: a path
    filters with the same sigma again and again."""
    return torch.from_numpy(_log2_spatial_weights(spatial_sigma, radius, sd).copy()).to(device)


@functools.cache
def _launcher():
    fn = library().monai_bilateral_filter
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bilateral_stencil(img: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
                      truncate: float = 2.0, *, seg: int | None = None) -> torch.Tensor:
    """Bilateral filter of a CUDA tensor (B, C, H, W) or (B, C, D, H, W) on the CUDA kernel
    that ``bilateral_plan`` names for its shape, radius and card (any radius; ``seg``
    forces the pair kernels' segment length, to time another one); adds one to
    ``bilateral_stencil.launches``. Float types other than float32 are cast to float32 and
    back; a non-contiguous input is copied."""
    return _launch(img, spatial_sigma, color_sigma, truncate, seg, None)


def bilateral_exps(img: torch.Tensor, spatial_sigma: float = 5.0, color_sigma: float = 0.5,
                   truncate: float = 2.0, *, seg: int | None = None) -> tuple[torch.Tensor, int]:
    """``bilateral_stencil`` on the checked build of the same kernel, which also adds up
    the exps its threads compute; returns the output and that count, which the plan's
    ``exps`` should equal. A check, not a path: the count costs an atomic a thread. Adds
    one to ``bilateral_stencil.launches``."""
    if not isinstance(img, torch.Tensor) or img.device.type != "cuda":
        raise ValueError("bilateral_exps runs on CUDA tensors")
    count = torch.zeros(1, dtype=torch.int64, device=img.device)
    out = _launch(img, spatial_sigma, color_sigma, truncate, seg, count)
    return out, int(count.item())


def _launch(img: torch.Tensor, spatial_sigma: float, color_sigma: float, truncate: float, seg: int | None,
            count: torch.Tensor | None) -> torch.Tensor:
    if not isinstance(img, torch.Tensor) or img.ndim not in (4, 5):
        raise ValueError(f"bilateral_stencil takes a (B, C, H, W) or (B, C, D, H, W) tensor; got "
                         f"{tuple(img.shape) if isinstance(img, torch.Tensor) else type(img)}")
    if torch.is_grad_enabled() and img.requires_grad:
        raise RuntimeError("bilateral_stencil is forward-only; run it under torch.inference_mode()")
    if img.device.type != "cuda":
        raise ValueError(f"bilateral_stencil runs on CUDA tensors, not {img.device}; "
                         "bilateral_filter takes the plain version elsewhere")
    if not img.dtype.is_floating_point:
        raise TypeError(f"bilateral_stencil takes a floating tensor; got {img.dtype}")
    if min(img.shape) <= 0:
        raise ValueError(f"bilateral_stencil takes a non-empty tensor; got {tuple(img.shape)}")
    sd = img.ndim - 2
    x = img.to(torch.float32).contiguous()
    radius = filter_radius(spatial_sigma, truncate)
    plan = bilateral_plan(tuple(x.shape), radius, _sms(x.device), seg)
    spatial = tuple(int(s) for s in x.shape[2:])
    dims = spatial if sd == 3 else (1, *spatial)
    lw = _log2_spatial_weights(float(spatial_sigma), radius, sd)
    lw_dev = _device_log2_weights(float(spatial_sigma), radius, sd, x.device) if plan["instance"] != "pair" else None
    nk = -0.5 / float(color_sigma) ** 2 * math.log2(math.e)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), out.data_ptr(), None if lw_dev is None else lw_dev.data_ptr(),
                          lw.ctypes.data, x.shape[0] * x.shape[1], sd, *dims, radius, nk, _INSTANCES[plan["instance"]],
                          plan["warps_x"], plan["warps_y"], plan["seg"], *plan["tiles"],
                          None if count is None else count.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilateral_stencil: CUDA launch failed with error {err} "
                           f"({tuple(img.shape)}, radius {radius}, {plan['label']})")
    count_launch(bilateral_stencil)
    return out.to(img.dtype)


bilateral_stencil.launches = 0
