"""The port's general resample, monai_tpu_torch/ops/resample.py, against monai_tpu/ops/resample.py.

- ``grid_pull`` at spline orders 0-7 under the eight bounds (sliding on a flow field of as
  many channels as axes), both ``align_corners``, in 2-D and 3-D, on coordinates that
  reach past both ends: in float64, both packages' math on the same numpy arrays, within
  1e-11 of max|ref| (the B-splines' truncated powers sum in another order); and in float32
  on ``jnp`` arrays at orders 0, 1, 3 and the cubic B-spline, within 1e-5 of max|ref|
  (float32 sums of the same taps), order 0 bit for bit. At orders 4-7 the JAX package's
  float32 B-spline weights lose up to ~7e-4 of max|ref| to the cancellation of x^7-sized
  truncated powers; the port sums them in float64 and rounds the weight once, so its
  float32 pull is held to the float64 reference within 1e-5 instead.
- per-dimension bound tuples, 'bspline', and the refusals (a tuple holding 'sliding', a
  flow field of the wrong channel count, an unknown mode).
- ``grid_push`` and ``grid_count`` in float64 against the JAX package's (1e-11), and the
  push as the pull's adjoint, <pull(x), y> = <x, push(y)> in float64 (1e-11 relative),
  wherever the JAX package's rule makes it one: everywhere but the Keys cubic (order 3)
  under border and reflection, where its push bounds the coordinate and its pull each tap.
- ``grid_grad`` at orders 1 and 3 against ``jax.grad`` on ``jnp`` float32 arrays
  (1e-5 of max|ref|), and at integer coordinates, where order 1 takes the difference to
  the right as ``jax.grad`` does.
- ``affine_grid`` and ``affine_resample`` (a rotated, sheared 3-D affine) and
  ``AffineTransform``, ``normalize_transform`` and ``to_norm_affine`` against the JAX
  package's.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monai_tpu.networks.layers import spatial_transforms as jax_st
from monai_tpu.ops import resample as J
from monai_tpu_torch.networks.layers import AffineTransform, normalize_transform, to_norm_affine
from monai_tpu_torch.ops import resample as R

BOUNDS = ("zeros", "border", "reflection", "dct1", "dst1", "dst2", "dft", "sliding")
SHAPES = {2: (2, 9, 11), 3: (3, 7, 8, 6)}  # as many channels as axes, for 'sliding'
GRIDS = {2: (5, 6), 3: (5, 6, 4)}


def _case(nd: int, seed: int):
    rng = np.random.RandomState(seed)
    shape = SHAPES[nd]
    spatial = np.array(shape[1:])
    grid = rng.rand(*GRIDS[nd], nd) * spatial * 1.6 - spatial * 0.3  # past both ends
    return rng.randn(*shape), grid


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _corners(bound: str) -> tuple:
    """``align_corners`` moves the reflection bound's mirrors only."""
    return (False, True) if bound == "reflection" else (False,)


@pytest.mark.parametrize("nd,order,bound", list(itertools.product((2, 3), range(8), BOUNDS)))
def test_grid_pull_float64_matches_jax(nd, order, bound):
    x, grid = _case(nd, 10 * nd + order)
    for ac in _corners(bound):
        ref = J.grid_pull(x, grid, order, bound, ac)
        got = R.grid_pull(torch.from_numpy(x), torch.from_numpy(grid), order, bound, ac)
        assert got.dtype == torch.float64 and _rel(got, ref) <= 1e-11, (ac, _rel(got, ref))


@pytest.mark.parametrize("nd,order,bound", list(itertools.product((2, 3), (0, 1, 3, "bspline"), BOUNDS)))
def test_grid_pull_float32_matches_jax(nd, order, bound):
    x, grid = (a.astype(np.float32) for a in _case(nd, 3 * nd))
    for ac in _corners(bound):
        ref = np.asarray(J.grid_pull(jnp.asarray(x), jnp.asarray(grid), order, bound, ac))
        got = R.grid_pull(torch.from_numpy(x), torch.from_numpy(grid), order, bound, ac)
        assert got.dtype == torch.float32
        if order == 0:
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            assert _rel(got, ref) <= 1e-5, (ac, _rel(got, ref))


@pytest.mark.parametrize("order", (4, 5, 6, 7))
def test_high_order_float32_is_held_to_float64(order):
    for nd in (2, 3):
        x, grid = _case(nd, order)
        for bound in ("zeros", "dct1", "dst2", "dft"):
            ref = J.grid_pull(x, grid, order, bound)
            got = R.grid_pull(torch.from_numpy(x).float(), torch.from_numpy(grid).float(), order, bound)
            assert _rel(got, ref) <= 1e-5, (nd, bound)


def test_per_dimension_bounds_and_bspline():
    x, grid = _case(3, 1)
    for bound in (("zeros", "dct1", "dft"), ["dst2", "replicate", "dst1"]):
        for order in (1, 3, 5, "bspline"):
            ref = J.grid_pull(x, grid, order, bound)
            assert _rel(R.grid_pull(torch.from_numpy(x), torch.from_numpy(grid), order, bound), ref) <= 1e-11
            y = np.random.RandomState(1).randn(3, *GRIDS[3])
            ref = J.grid_push(y, grid, x.shape[1:], order, bound)
            assert _rel(R.grid_push(torch.from_numpy(y), torch.from_numpy(grid), x.shape[1:], order, bound),
                        ref) <= 1e-11
    assert R.resolve_bound(["reflect", "wrap"]) == J.resolve_bound(["reflect", "wrap"]) == ("dct2", "dft")
    assert all(R.resolve_mode(m) == J.resolve_mode(m) for m in ("nearest", "bilinear", "bicubic", "fifth", 7))
    t = torch.zeros(2, 4, 4)
    for kwargs, error in ((dict(bound=("zeros", "sliding")), ValueError), (dict(bound="sliding"), ValueError),
                          (dict(interpolation="lanczos"), ValueError), (dict(bound="mirrored"), ValueError)):
        with pytest.raises(error):
            R.grid_pull(t[:1], torch.zeros(3, 2), **kwargs)


@pytest.mark.parametrize("nd,order,bound", list(itertools.product((2, 3), range(8), BOUNDS)))
def test_grid_push_and_count_match_jax_and_push_is_the_adjoint(nd, order, bound):
    x, grid = _case(nd, 7 * nd + order)
    shape = x.shape[1:]
    y = np.random.RandomState(order).randn(x.shape[0], *GRIDS[nd])
    ref = J.grid_push(y, grid, shape, order, bound)
    pushed = R.grid_push(torch.from_numpy(y), torch.from_numpy(grid), shape, order, bound)
    assert _rel(pushed, ref) <= 1e-11
    count = R.grid_count(torch.from_numpy(grid), shape, order, bound)
    assert _rel(count, J.grid_count(grid, shape, order, bound)) <= 1e-11
    if order == 3 and bound in ("border", "reflection"):
        return  # the Keys cubic's push bounds the coordinate, its pull each tap: no adjoint pair
    pulled = R.grid_pull(torch.from_numpy(x), torch.from_numpy(grid), order, bound)
    lhs, rhs = float((pulled * torch.from_numpy(y)).sum()), float((torch.from_numpy(x) * pushed).sum())
    assert abs(lhs - rhs) <= 1e-11 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("order,bound", [(1, "zeros"), (1, "reflection"), (1, "sliding"), (3, "zeros"),
                                         (3, "border"), (3, "dft")])
def test_grid_grad_matches_jax(order, bound):
    x, grid = (a.astype(np.float32) for a in _case(2, order))
    ref = np.asarray(J.grid_grad(jnp.asarray(x), jnp.asarray(grid), order, bound))
    got = R.grid_grad(torch.from_numpy(x), torch.from_numpy(grid), order, bound)
    assert got.shape == (2, *GRIDS[2], 2) and _rel(got, ref) <= 1e-5, _rel(got, ref)


def test_grid_grad_at_integer_coordinates_is_the_difference_to_the_right():
    x = np.random.RandomState(2).randn(1, 6, 7).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(1, 5), np.arange(1, 6), indexing="ij"), -1).astype(np.float32)
    got = R.grid_grad(torch.from_numpy(x), torch.from_numpy(grid), 1, "zeros").numpy()[0]
    ref = np.asarray(J.grid_grad(jnp.asarray(x), jnp.asarray(grid), 1, "zeros"))[0]
    np.testing.assert_array_equal(got, ref)
    i, j = grid[..., 0].astype(int), grid[..., 1].astype(int)
    np.testing.assert_allclose(got[..., 0], x[0][i + 1, j] - x[0][i, j], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 1], x[0][i, j + 1] - x[0][i, j], rtol=0, atol=1e-6)


def test_affine_grid_and_affine_resample_match_jax():
    rng = np.random.RandomState(4)
    a = np.eye(4)
    a[:3, :3] = np.array([[0.9, -0.3, 0.1], [0.35, 0.85, -0.2], [0.05, 0.25, 1.1]])
    a[:3, 3] = [-1.5, 2.0, 0.5]
    out_shape = (9, 10, 7)
    np.testing.assert_allclose(R.affine_grid(a, out_shape).numpy(), J.affine_grid(a, out_shape), rtol=0, atol=1e-12)
    img = rng.rand(2, 10, 9, 8).astype(np.float32)
    for mode, pad in ((0, "zeros"), (1, "border"), (3, "reflection"), (2, "dct1"), ("bspline", "dft")):
        ref = np.asarray(J.affine_resample(jnp.asarray(img), a, out_shape, mode, pad))
        got = R.affine_resample(torch.from_numpy(img), a, out_shape, mode, pad)
        assert got.shape == (2, *out_shape) and _rel(got, ref) <= 1e-5, (mode, pad)


@pytest.mark.parametrize("align_corners,zero_centered", [(False, False), (True, False), (False, True)])
def test_affine_transform_matches_jax(align_corners, zero_centered):
    np.testing.assert_allclose(normalize_transform((5, 7), align_corners, zero_centered).numpy(),
                               np.asarray(jax_st.normalize_transform((5, 7), align_corners, zero_centered)),
                               rtol=0, atol=1e-7)  # the JAX package's float64 request is float32 without x64
    rng = np.random.RandomState(6)
    theta = np.array([[[0.9, -0.2, 1.0], [0.25, 1.05, -2.0], [0, 0, 1]]])
    np.testing.assert_allclose(to_norm_affine(torch.from_numpy(theta), (8, 9), (6, 7), align_corners).numpy(),
                               np.asarray(jax_st.to_norm_affine(jnp.asarray(theta), (8, 9), (6, 7), align_corners)),
                               rtol=0, atol=1e-6)
    src = rng.rand(2, 2, 8, 9).astype(np.float32)
    kw = dict(spatial_size=(6, 7), align_corners=align_corners, padding_mode="border",
              zero_centered=zero_centered or None)
    ref = np.asarray(jax_st.AffineTransform(**kw)(jnp.asarray(src), jnp.asarray(theta[0, :2], jnp.float32)))
    got = AffineTransform(**kw)(torch.from_numpy(src), torch.from_numpy(theta[0, :2]).float())
    assert _rel(got.numpy(), ref) <= 1e-5
