"""``bilateral_plan`` (ops/bilateral.py), on the CPU: which bilateral kernel a shape and
radius launch, its geometry, and the exps a voxel it computes.

- The instance at each radius and dimension: the pair kernels for 2-D r = 1..8 and 3-D
  r = 1..3, the tap kernel with shared memory up to 48 KB of tile, from global memory past.
- At the filtering path's stage A (3-D, r = 2) and stage B (2-D, r = 5) shapes: between
  (T - 1) / 2, the least the function needs, and 0.75 (T - 1).
- The same plan, and so the same instance, for the same shape twice.
- The plan's geometry walked block by block in float64 (the tiling, each block's staged
  tile, its halo steps, and the kernels' centred, scaled exp2 form of the weights) against
  the JAX package's stencil (float32, atol 1e-5), with exactly the exps the plan counts.
  How the kernels share a pair's exp, and their own exp count, are held on the card
  (tests/test_torch_cuda_kernels.py).
- The plan's constants against the ones csrc/bilateral_filter.cu compiles, the block
  shape the width picks, the segments for the card's SM count or a forced length.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from monai_tpu.ops import filtering as jax_filtering
from monai_tpu_torch.ops import bilateral as port_bilateral
from monai_tpu_torch.ops.bilateral import (KM, KX, MIN_WAVES, PAIR_RADIUS, PAIR_WARPS, TAP_SHARED_BYTES, TAP_TILE,
                                           _pair_exps, bilateral_plan, filter_radius,
                                           spatial_weights)

STAGE_A, STAGE_B = (1, 1, 270, 270, 224), (90, 1, 512, 512)


@pytest.mark.parametrize("sd,radius,instance", [(2, r, "pair") for r in range(1, 9)]
                         + [(3, r, "pair") for r in range(1, 4)]
                         + [(2, 9, "tap-shared"), (2, 45, "tap-shared"), (2, 46, "tap-global"),
                            (3, 4, "tap-shared"), (3, 5, "tap-shared"), (3, 6, "tap-global")])
def test_instance_at_each_radius(sd, radius, instance):
    shape = (2, 3, 40, 50) if sd == 2 else (2, 3, 20, 30, 40)
    plan = bilateral_plan(shape, radius)
    assert plan["instance"] == instance
    assert plan["label"].startswith(instance) and f"{sd}d" in plan["label"]
    assert plan["taps"] == (2 * radius + 1) ** sd and plan["least_exps"] == (plan["taps"] - 1) / 2
    assert plan["smem"] <= TAP_SHARED_BYTES
    if instance == "pair":
        assert radius <= PAIR_RADIUS[sd]
        assert plan["label"].endswith(f"r{radius}")


@pytest.mark.parametrize("shape,radius", [(STAGE_A, 2), (STAGE_B, 5)])
def test_exps_per_voxel_at_the_stages(shape, radius):
    plan = bilateral_plan(shape, radius)
    assert plan["instance"] == "pair"
    assert plan["least_exps"] <= plan["exps_per_voxel"] <= 0.75 * (plan["taps"] - 1)


@pytest.mark.parametrize("shape,radius", [(STAGE_A, 2), (STAGE_B, 5), ((3, 1, 9, 20, 100), 3), ((1, 1, 30, 70), 46)])
def test_same_plan_for_the_same_shape(shape, radius):
    first = bilateral_plan(shape, radius)
    again = bilateral_plan(list(shape), radius)
    assert again is first  # cached per shape
    assert again["instance"] == first["instance"] and again["label"] == first["label"]


@pytest.mark.parametrize("shape,radius", [(STAGE_A, 2), (STAGE_B, 5), ((2, 1, 7, 33, 101), 1), ((4, 1, 3, 1000), 8)])
def test_pair_geometry_covers_the_image(shape, radius):
    p = bilateral_plan(shape, radius)
    sd = len(shape) - 2
    d, h, w = (1, *shape[2:]) if sd == 2 else shape[2:]
    stream, rows = (h, 1) if sd == 2 else (d, h)
    tiles_x, tiles_y, nseg = p["tiles"]
    assert p["cols_per_warp"] == (32 - 2 * p["halo_lanes"]) * p["kx"] and p["halo_lanes"] * p["kx"] >= radius
    assert (tiles_x - 1) * p["warps_x"] * p["cols_per_warp"] < w <= tiles_x * p["warps_x"] * p["cols_per_warp"]
    assert (tiles_y - 1) * p["warps_y"] * p["km"] < rows <= tiles_y * p["warps_y"] * p["km"]
    assert (nseg - 1) * p["seg"] < stream <= nseg * p["seg"]
    assert p["blocks"] == shape[0] * shape[1] * tiles_x * tiles_y * nseg
    assert p["threads"] == 32 * p["warps_x"] * p["warps_y"] <= 128


def _pair_schedule(x: np.ndarray, ss: float, cs: float) -> tuple[np.ndarray, int]:
    """What the plan decides for (B, C, *spatial) ``x``, walked block by block in float64:
    each block stages its tile (the walked axis from r steps before its segment to r past
    it, r rows and r + halo lanes' columns around its own, clamped, minus the block's
    first value, times sqrt(log2(e) / 2 cs^2)), writes its voxels from that tile alone with
    weights exp2(log2 ws - df^2), and its lanes compute the exps of every step including
    the r halo steps. Returns the output, nan where no block wrote, and the exps. How the
    kernels share a pair's exp is held to the plain version on the card."""
    sd = x.ndim - 2
    r = filter_radius(ss)
    p = bilateral_plan(x.shape, r)
    lw = np.log2(spatial_weights(float(ss), r, sd).astype(np.float64)).reshape((2 * r + 1,) * sd)
    lw = lw[:, None, :] if sd == 2 else lw  # (a, b, c): walked axis, rows, columns
    sc = math.sqrt(0.5 / cs ** 2 * math.log2(math.e))
    xv = x.reshape(-1, *x.shape[2:]).astype(np.float64)
    xv = xv[:, :, None, :] if sd == 2 else xv  # (planes, walked axis, rows, columns)
    d, h, w = xv.shape[1:]
    kx, km, hl, ox, wx, wy, seg = (p[k] for k in ("kx", "km", "halo_lanes", "cols_per_warp", "warps_x", "warps_y", "seg"))
    rm, cm = (r if sd == 3 else 0), hl * kx + r  # the staged rows and columns before a block's own
    per_a = _pair_exps(sd, r)
    out, writes, exps = np.full(xv.shape, np.nan), np.zeros(xv.shape, int), 0
    for pl, bs, by, bx in np.ndindex(xv.shape[0], p["tiles"][2], p["tiles"][1], p["tiles"][0]):
        x_b, y_b, t0 = bx * wx * ox, by * wy * km, bs * seg
        t1, y1, x1 = min(t0 + seg, d), min(y_b + wy * km, h), min(x_b + wx * ox, w)
        m = xv[pl, t0, y_b, x_b]
        idx = [np.clip(np.arange(lo - pad, hi + pad), 0, n - 1)
               for lo, hi, pad, n in ((t0, t1, r, d), (y_b, y_b + wy * km, rm, h), (x_b, x_b + wx * ox, cm, w))]
        tile = (xv[pl][np.ix_(*idx)] - m) * sc
        exps += p["threads"] * sum(sum(per_a[max(t0 - t, 0):]) for t in range(t0 - r, t1))
        n_t, n_y, n_x = t1 - t0, y1 - y_b, x1 - x_b
        centre = tile[r:r + n_t, rm:rm + n_y, cm:cm + n_x]
        num, den = np.zeros_like(centre), np.zeros_like(centre)
        for a, b, c in np.ndindex(*lw.shape):
            a, b, c = a - r, b - (r if sd == 3 else 0), c - r
            nb = tile[r + a:r + a + n_t, rm + b:rm + b + n_y, cm + c:cm + c + n_x]
            wt = np.exp2(lw[a + r, b + lw.shape[1] // 2, c + r] - (nb - centre) ** 2)
            num, den = num + wt * nb, den + wt
        out[pl, t0:t1, y_b:y1, x_b:x1] = m + num / den / sc
        writes[pl, t0:t1, y_b:y1, x_b:x1] += 1
    assert (writes == 1).all()  # every voxel written once
    return out.reshape(x.shape), exps


@pytest.mark.parametrize("shape,ss,cs", [
    ((1, 1, 21, 200), 2.5, 0.3),     # 2-D r = 5: two warps, three segments
    ((2, 1, 5, 7), 0.5, 0.3),        # 2-D r = 1, sizes past the warp by little
    ((9, 1, 2, 3), 4.0, 0.2),        # 2-D r = 8, nine planes of 2 x 3: sizes <= r
    ((1, 1, 10, 17, 60), 1.0, 0.1),  # 3-D r = 2: three column tiles, one past a block's rows
    ((1, 2, 3, 2, 4), 1.5, 0.3),     # 3-D r = 3: sizes <= r, two planes
])
def test_pair_schedule_matches_the_jax_stencil(shape, ss, cs):
    x = np.random.RandomState(9).rand(*shape).astype(np.float32)
    got, exps = _pair_schedule(x, ss, cs)
    ref = np.asarray(jax_filtering.bilateral_filter(jnp.asarray(x), ss, cs))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert exps == bilateral_plan(x.shape, filter_radius(ss))["exps"]


def test_pair_schedule_keeps_a_constant_image():
    x = np.full((1, 1, 7, 9, 11), 3.7, dtype=np.float32)
    got, _ = _pair_schedule(x, 1.0, 0.3)
    assert np.abs(got - x.astype(np.float64)).max() == 0.0


CSRC = (Path(port_bilateral.__file__).resolve().parent.parent / "csrc" / "bilateral_filter.cu").read_text()


def _cxx_int(name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", CSRC).group(1))


@pytest.mark.parametrize("python,cxx", [
    (lambda: PAIR_RADIUS[3], "kMaxR3"), (lambda: PAIR_RADIUS[2], "kMaxR2"), (lambda: KM[3], "kKm3"),
    (lambda: KX[2], "kKx2"), (lambda: PAIR_WARPS[3], "kWarps3"), (lambda: TAP_TILE[2], "kTileX"),
    (lambda: TAP_TILE[1], "kTileY"), (lambda: TAP_TILE[0], "kTileZ"), (lambda: TAP_SHARED_BYTES // 1024, "kSharedBudget"),
])
def test_plan_constants_match_the_kernel_source(python, cxx):
    assert python() == _cxx_int(cxx)


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_four_warps_across_where_they_fill_the_width(radius):
    """3-D: four warps side by side where the width is four warps' columns (the layout of
    stage A's 224 columns at r = 2); one where it is one warp's."""
    ox = 32 - 2 * radius
    assert bilateral_plan((1, 1, 9, 20, 4 * ox), radius)["warps_x"] == 4
    assert bilateral_plan((1, 1, 9, 20, ox), radius)["warps_x"] == 1


@pytest.mark.parametrize("shape,radius", [(STAGE_A, 2), (STAGE_B, 5)])
@pytest.mark.parametrize("sms", [66, 114, 132])
def test_segments_follow_the_cards_sms(shape, radius, sms):
    """The segments give MIN_WAVES waves of resident blocks or more on a card of ``sms``
    SMs, as few as do; the plan is cached per SM count."""
    plan = bilateral_plan(shape, radius, sms)
    assert plan["waves"] == math.ceil(plan["blocks"] / sms) / plan["resident"] >= MIN_WAVES
    assert bilateral_plan(shape, radius, sms) is plan
    assert plan["exps"] == round(plan["exps_per_voxel"] * math.prod(shape))


@pytest.mark.parametrize("shape,radius,seg", [(STAGE_A, 2, 30), (STAGE_B, 5, 64), ((2, 1, 50, 40), 3, 1000)])
def test_a_forced_segment_length(shape, radius, seg):
    """``seg`` sets the segment length (at most the walked axis); fewer segments run fewer
    halo steps, so fewer exps."""
    plan, own = bilateral_plan(shape, radius, seg=seg), bilateral_plan(shape, radius)
    stream = shape[2]
    assert plan["seg"] == min(seg, stream) and plan["tiles"][2] == math.ceil(stream / plan["seg"])
    assert plan["tiles"][:2] == own["tiles"][:2]
    per_a = _pair_exps(len(shape) - 2, radius)
    halo = sum(sum(per_a[k:]) for k in range(1, radius + 1))
    per_seg = math.prod(shape[:2]) * plan["tiles"][0] * plan["tiles"][1] * plan["threads"] * halo
    assert plan["exps"] - own["exps"] == (plan["tiles"][2] - own["tiles"][2]) * per_seg
