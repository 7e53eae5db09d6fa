"""monai_tpu_torch's separable resample (kernel 3's plain version, its tap tables, its
launch plan and the resample tiers) against monai_tpu's, on the CPU.

The plain version is held to the JAX package's Pallas kernel (interpret mode) and to its
numpy ``separable_affine_resample`` at the shapes of ``tests/test_pallas_resample.py``,
for orders {0, 1, 3} x bounds {zeros, border, reflection}: within 1e-5 of max|ref|
(float32 sums in another order), and exactly for order 0 (weights 1 or 0). The tap
tables that the CUDA kernel reads rebuild ``interp_matrix`` exactly, and summing them
as the kernel does (per output row, taps in ascending index order, axis 1, 2, then 3)
gives the plain version's result. The kernel's launch plan (``resample_plan``) is held to
what the kernel needs: its tiles cover the output once, every block fits in shared
memory, every nonzero tap of a tile's rows lies in its brick, and a walk over the tiles in
numpy, each tile computed from its brick alone in the plan's order, gives the plain
version's result (exactly at order 0, within 1e-5 of max|ref| otherwise).
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monai_tpu.ops.pallas_resample import pallas_separable_resample_3d
from monai_tpu.ops.separable import interp_matrix as jax_interp_matrix
from monai_tpu.ops.separable import separable_affine_resample as jax_separable
from monai_tpu.transforms.lazy_utils import apply_affine_to_data as jax_apply_affine_to_data
from monai_tpu_torch.ops.separable import interp_matrix, separable_affine_resample
from monai_tpu_torch.ops.separable_resample import (FUSED_SMEM, SMEM_MAX, interp_taps, resample_plan,
                                                    separable_resample_3d, separable_resample_3d_plain,
                                                    taps_from_matrix)
from monai_tpu_torch.transforms.lazy_utils import apply_affine_to_data

ORDERS, BOUNDS = (0, 1, 3), ("zeros", "border", "reflection")
M = np.diag([0.75, 1.3, 0.5, 1.0])
M[:3, 3] = [0.4, -1.2, 2.5]
OUT = (32, 16, 40)
SPLEEN = np.diag([1.8987341256425134, 1.8987341256425134, 0.4, 1.0])  # the bundle's Spacing op
# (n_in, n_out, scale, offset): downsampling, upsampling, both spleen axes and the inverse,
# a depth-1 axis, and coordinates far outside the input
AXES = [(20, 9, 2.1, -0.3), (9, 20, 0.43, 0.2), (512, 270, 1.8987341256425134, 0.0), (90, 224, 0.4, 0.0),
        (270, 512, 1 / 1.8987341256425134, 0.0), (1, 1, 1.0, 0.0), (5, 17, 0.3, -3.0), (7, 7, 1.0, 0.0)]


@pytest.fixture(scope="module")
def img():
    return np.random.RandomState(0).rand(2, 24, 20, 28).astype(np.float32)


def _close(got: np.ndarray, ref: np.ndarray, order: int) -> None:
    assert got.shape == ref.shape
    if order == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _tap_sum(x: torch.Tensor, matrix: np.ndarray, out_shape, order: int, bound: str, align_corners=False):
    """The CUDA kernel's arithmetic in PyTorch: each axis in turn, each output row the sum
    of its taps in ascending index order, identity axes skipped."""
    for d in range(3):
        taps = interp_taps(x.shape[1 + d], out_shape[d], float(matrix[d, d]), float(matrix[d, 3]), order, bound,
                           align_corners)
        if taps is None:
            continue
        idx, w = (torch.from_numpy(a.copy()) for a in taps)
        acc = torch.zeros(x.shape[:1 + d] + (out_shape[d],) + x.shape[2 + d:])
        shape = [1] * x.ndim
        shape[1 + d] = -1
        for t in range(idx.shape[1]):
            acc = acc + w[:, t].view(shape) * x.index_select(1 + d, idx[:, t].long())
        x = acc
    return x


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("bound", BOUNDS)
def test_plain_matches_jax_kernel_and_einsum(img, order, bound):
    got = separable_resample_3d(torch.from_numpy(img), M, OUT, order, bound).numpy()
    _close(got, np.asarray(pallas_separable_resample_3d(jnp.asarray(img), M, OUT, order=order, bound=bound,
                                                        interpret=True)), order)
    _close(got, jax_separable(img, M, OUT, order=order, bound=bound), order)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("bound", BOUNDS)
def test_kernel_arithmetic_matches_plain(img, order, bound):
    for align_corners in (False, True):
        x = torch.from_numpy(img)
        got = _tap_sum(x, M, OUT, order, bound, align_corners).numpy()
        _close(got, separable_resample_3d_plain(x, M, OUT, order, bound, align_corners).numpy(), order)


@pytest.mark.parametrize("n_in,n_out,scale,offset", AXES)
def test_interp_matrix_and_taps(n_in, n_out, scale, offset):
    """The port's copy of interp_matrix equals the JAX package's; its tap table rebuilds it
    exactly (folded border and reflection taps summed, rows padded with weight 0)."""
    for order in ORDERS:
        for bound in BOUNDS:
            for align_corners in (False, True):
                W = interp_matrix(n_in, n_out, scale, offset, order, bound, align_corners)
                np.testing.assert_array_equal(W, jax_interp_matrix(n_in, n_out, scale, offset, order, bound,
                                                                   align_corners))
                idx, w = taps_from_matrix(W)
                assert idx.dtype == np.int32 and w.dtype == np.float32 and idx.shape == (n_out, idx.shape[1])
                assert idx.shape[1] <= {0: 1, 1: 2, 3: 4}[order]
                assert (idx >= 0).all() and (idx < n_in).all()
                rebuilt = np.zeros_like(W)
                np.add.at(rebuilt, (np.arange(n_out)[:, None].repeat(idx.shape[1], 1), idx), w)
                np.testing.assert_array_equal(rebuilt, W)
                taps = interp_taps(n_in, n_out, scale, offset, order, bound, align_corners)
                assert (taps is None) == (n_in == n_out and np.array_equal(W, np.eye(n_in)))


def test_spleen_sites():
    """The path's two sites: (512, 512, 90) -> (270, 270, 224) at order 1, border, two
    taps per row; and back at order 0, one tap per row. Values at a small channel-free
    stand-in of the same axes would be slow on the CPU, so each axis is checked alone."""
    assert interp_matrix(512, 270, SPLEEN[0, 0], 0.0, 1, "border").shape == (270, 512)
    assert interp_taps(512, 270, SPLEEN[0, 0], 0.0, 1, "border")[0].shape == (270, 2)
    assert interp_taps(90, 224, 0.4, 0.0, 1, "border")[0].shape == (224, 2)
    inv = np.linalg.inv(SPLEEN)
    assert interp_taps(270, 512, inv[0, 0], 0.0, 0, "border")[0].shape == (512, 1)
    assert interp_taps(224, 90, inv[2, 2], 0.0, 0, "border")[0].shape == (90, 1)


@pytest.mark.parametrize("order", ORDERS)
def test_torch_separable_matches_jax_in_2d_and_3d(img, order):
    m2 = np.array([[1.4, 0.0, 0.3], [0.0, 0.6, -0.5], [0.0, 0.0, 1.0]])
    got2 = separable_affine_resample(torch.from_numpy(img[:, 0]), m2, (15, 30), order, "zeros").numpy()
    _close(got2, jax_separable(img[:, 0], m2, (15, 30), order=order, bound="zeros"), order)
    ints = separable_affine_resample(torch.from_numpy((img * 10).astype(np.int32)), M, OUT, order, "border")
    assert ints.dtype == torch.float32


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("bound", BOUNDS)
def test_apply_affine_to_data_2d_runs_as_a_depth_1_volume(img, order, bound):
    m2 = np.array([[1.4, 0.0, 0.3], [0.0, 0.6, -0.5], [0.0, 0.0, 1.0]])
    got = apply_affine_to_data(torch.from_numpy(img[:, 0]), m2, (15, 30), mode=order, padding_mode=bound)
    _close(got.numpy(), np.asarray(jax_apply_affine_to_data(img[:, 0], m2, (15, 30), mode=order,
                                                            padding_mode=bound)), order)


@pytest.mark.parametrize("matrix,out_shape,padding_mode", [
    (np.array([[-1.0, 0, 0, 23], [0, -1, 0, 19], [0, 0, 1, 0], [0, 0, 0, 1]]), (24, 20, 28), "zeros"),  # RAS flip
    (np.array([[0.0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]), (20, 24, 28), "zeros"),        # transpose
    (np.array([[1.0, 0, 0, -3], [0, 1, 0, 2], [0, 0, -1, 30], [0, 0, 0, 1]]), (30, 16, 33), "zeros"),     # pad, crop
    (np.array([[1.0, 0, 0, -3], [0, 1, 0, 2], [0, 0, 1, -2], [0, 0, 0, 1]]), (30, 16, 33), "border"),
    (np.array([[1.0, 0, 0, -3], [0, 1, 0, 2], [0, 0, 1, -2], [0, 0, 0, 1]]), (30, 16, 33), "reflection"),
])
def test_integer_tier_matches_jax(img, matrix, out_shape, padding_mode):
    got = apply_affine_to_data(torch.from_numpy(img), matrix, out_shape, mode=1, padding_mode=padding_mode)
    ref = np.asarray(jax_apply_affine_to_data(img, matrix, out_shape, mode=1, padding_mode=padding_mode))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_general_affine_is_not_ported(img):
    rot = np.eye(4)
    rot[:2, :2] = [[0.8, -0.6], [0.6, 0.8]]
    with pytest.raises(NotImplementedError, match="Native ops"):
        apply_affine_to_data(torch.from_numpy(img), rot, OUT)


@pytest.mark.parametrize("kwargs,error", [
    (dict(img=torch.zeros(24, 20, 28)), ValueError),                              # not (C, Z, Y, X)
    (dict(img=torch.zeros(1, 4, 4, 4, dtype=torch.float64)), TypeError),          # dtype
    (dict(img=torch.zeros(1, 4, 4, 4, dtype=torch.bfloat16)), TypeError),
    (dict(img=torch.zeros(1, 4, 5, 6).transpose(1, 3)), ValueError),              # not contiguous
    (dict(matrix=np.array([[1.0, 0.2, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])), ValueError),  # shear
    (dict(matrix=np.eye(3)), ValueError),                                         # 2-D affine
    (dict(out_shape=(4, 4)), ValueError),
    (dict(out_shape=(4, 0, 4)), ValueError),
    (dict(order=2), ValueError),
    (dict(bound="wrap"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(kwargs, error):
    args = dict(img=torch.zeros(1, 4, 4, 4), matrix=np.eye(4), out_shape=(4, 4, 4), order=1, bound="zeros")
    args.update(kwargs)
    with torch.inference_mode(), pytest.raises(error):
        separable_resample_3d(args.pop("img"), args.pop("matrix"), args.pop("out_shape"), **args)


def test_wrapper_refuses_grad_and_cpu_takes_the_plain_path(img):
    x = torch.from_numpy(img)
    with pytest.raises(RuntimeError, match="forward-only"):
        separable_resample_3d(x.clone().requires_grad_(), M, OUT)
    before = separable_resample_3d.launches
    with torch.inference_mode():
        assert torch.equal(separable_resample_3d(x, M, OUT, 3, "reflection"),
                           separable_resample_3d_plain(x, M, OUT, 3, "reflection"))
    assert separable_resample_3d.launches == before


def _diag(scales, offsets):
    m = np.diag([*scales, 1.0])
    m[:3, 3] = offsets
    return m


# (input shape, affine, output shape): up- and down-sampling, a 2-D image as depth 1, every
# axis the identity, one axis resampled and one flipped, tiles that straddle every edge
# with C = 3, and output rows wholly outside the input (empty rows under zeros)
PLAN_CASES = [
    ((2, 13, 17, 11), _diag([0.45, 0.7, 0.38], [0.3, -0.6, 0.1]), (29, 24, 27)),
    ((1, 31, 27, 33), _diag([2.9, 2.3, 1.9], [-0.4, 0.5, 0.2]), (11, 13, 17)),
    ((3, 1, 19, 21), _diag([1.0, 0.55, 1.7], [0.0, 0.25, -1.5]), (1, 35, 13)),
    ((1, 9, 10, 11), _diag([1.0, 1.0, 1.0], [0.0, 0.0, 0.0]), (9, 10, 11)),
    ((1, 12, 14, 16), _diag([1.25, 1.0, -1.0], [-2.0, 0.0, 15.0]), (9, 14, 16)),
    ((3, 9, 23, 100), _diag([0.45, 0.7, 0.33], [0.3, -0.2, 0.1]), (19, 33, 300)),
    ((1, 20, 21, 22), _diag([0.9, 1.1, 0.8], [-6.0, 5.0, -9.0]), (37, 45, 70)),
]
AXES_CASE = ((1, 5, 5, 16000), _diag([2.0, 2.0, 800.0], [0.1, 0.2, 3.0]), (2, 2, 20))  # 800x along x


def _tile_walk(x: np.ndarray, plan) -> np.ndarray:
    """The fused kernel's arithmetic in numpy: each tile from its brick alone, contracted
    in the plan's order with the plan's (band-relative) taps; asserts that the tiles cover
    the output once and that every brick lies inside the input."""
    out = plan.out_shape
    y = np.zeros((x.shape[0], *out), np.float32)
    cover = np.zeros(y.shape, np.int32)
    for c, t in itertools.product(range(x.shape[0]), itertools.product(*(range(n) for n in plan.tiles))):
        org = [t[a] * plan.tile[a] for a in range(3)]
        ln = [min(plan.tile[a], out[a] - org[a]) for a in range(3)]
        st = [org[a] if plan.identity[a] else int(plan.starts[a][t[a]]) for a in range(3)]
        bl = [ln[a] if plan.identity[a] else plan.band[a] for a in range(3)]
        b = x[c, st[0]:st[0] + bl[0], st[1]:st[1] + bl[1], st[2]:st[2] + bl[2]]
        assert min(ln) > 0 and min(st) >= 0 and b.shape == tuple(bl)
        for a in plan.order:
            ri, rw = plan.idx[a][org[a]:org[a] + ln[a]], plan.w[a][org[a]:org[a] + ln[a]]
            assert (ri >= 0).all() and (ri < bl[a]).all()  # padded taps too: the kernel reads them
            shape = [1, 1, 1]
            shape[a] = -1
            acc = np.zeros(b.shape[:a] + (ln[a],) + b.shape[a + 1:], np.float32)
            for k in range(plan.taps):
                acc = (acc + rw[:, k].reshape(shape) * np.take(b, ri[:, k], axis=a)).astype(np.float32)
            b = acc
        box = (c, slice(org[0], org[0] + ln[0]), slice(org[1], org[1] + ln[1]), slice(org[2], org[2] + ln[2]))
        y[box] = b
        cover[box] += 1
    assert (cover == 1).all()
    return y


def _check_bands(plan, matrix, order, bound, align_corners):
    """Every nonzero of every row of interp_matrix lies in its tile's band."""
    for a in plan.order:
        W = interp_matrix(plan.in_shape[1 + a], plan.out_shape[a], float(matrix[a, a]), float(matrix[a, 3]), order,
                          bound, align_corners)
        for i, row in enumerate(W):
            cols = np.nonzero(row)[0]
            start = plan.starts[a][i // plan.tile[a]]
            assert ((cols >= start) & (cols < start + plan.band[a])).all(), (a, i, cols, start, plan.band[a])


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("bound", BOUNDS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_tiles_bricks_and_walk_match_plain(case, order, bound, align_corners):
    """The plan the wrapper takes and one of forced small tiles (edges straddled on every
    axis the output allows, one float a copy along x)."""
    shape, m, out = PLAN_CASES[case]
    x = np.random.RandomState(case).randn(*shape).astype(np.float32)
    ref = separable_resample_3d_plain(torch.from_numpy(x), m, out, order, bound, align_corners).numpy()
    for plan in (resample_plan(shape, out, m, order, bound, align_corners),
                 resample_plan(shape, out, m, order, bound, align_corners, vec=1, tile=(3, 5, 32))):
        assert plan.route == "fused" and plan.launches == 1 and plan.smem <= SMEM_MAX
        assert plan.identity == tuple(interp_taps(shape[1 + a], out[a], m[a, a], m[a, 3], order, bound,
                                                  align_corners) is None for a in range(3))
        assert sorted(plan.order) == [a for a in range(3) if not plan.identity[a]]
        _check_bands(plan, m, order, bound, align_corners)
        _close(_tile_walk(x, plan), ref, order)
    assert plan.smem <= FUSED_SMEM or plan.tile == (3, 5, 32)
    assert resample_plan(shape, out, m, order, bound, align_corners).smem <= FUSED_SMEM


@pytest.mark.parametrize("order", ORDERS)
def test_strong_down_sampling_takes_the_axes_route(order):
    """800x along x: no tile's brick fits, so one pass an axis, x first (it shrinks most);
    the passes in numpy with the plan's tables give the plain version's result."""
    shape, m, out = AXES_CASE
    plan = resample_plan(shape, out, m, order, "border")
    assert plan.route == "axes" and plan.order == (2, 0, 1) and plan.launches == 3
    assert plan.bytes_fused is None and plan.tmp == (5 * 5 * 20, 2 * 5 * 20)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    y = x
    for a in plan.order:
        acc = 0
        for k in range(plan.taps):
            shp = [1, 1, 1, 1]
            shp[1 + a] = -1
            acc = (acc + plan.w[a][:, k].reshape(shp) * np.take(y, plan.idx[a][:, k], axis=1 + a)).astype(np.float32)
        y = acc
    _close(y, separable_resample_3d_plain(torch.from_numpy(x), m, out, order, "border").numpy(), order)


def test_spleen_site_plans():
    """The path's two sites take the fused route, one launch each, within 48 KB of shared
    memory; the Spacing site contracts axis 1 first, the inverse axis 3 (the axes that
    shrink the data); their bricks move little more than the bound, far less than a pass
    an axis."""
    inv = np.linalg.inv(SPLEEN)
    for shape, m, out, order, first in (((1, 512, 512, 90), SPLEEN, (270, 270, 224), 1, 0),
                                        ((1, 270, 270, 224), inv, (512, 512, 90), 0, 2)):
        plan = resample_plan(shape, out, m, order, "border")
        assert plan.route == "fused" and plan.launches == 1 and plan.smem <= FUSED_SMEM
        assert plan.order[0] == first and plan.tile[2] == out[2] and not any(plan.identity)
        assert plan.bytes_bound == 4 * (512 * 512 * 90 + 270 * 270 * 224)
        assert plan.bytes_bound < plan.bytes_fused < 1.2 * plan.bytes_bound < plan.bytes_axes
        _check_bands(plan, m, order, "border", False)
