"""monai_tpu_torch's filtering slice against monai_tpu's, on the CPU, in float32.

- The bilateral stencil (kernels 4 and 5's plain version, and ``bilateral_filter``,
  which takes it for every CPU tensor) against the JAX package's XLA stencil and its
  Pallas kernel in interpret mode, atol 1e-5: the Pallas tests' shapes, B·C > 1, sizes
  <= r, radii beyond the Pallas caps (the XLA stencil is the oracle there) and 1-D.
- ``gaussian_1d`` to 1e-7; ``separable_filtering`` and ``gaussian_filter`` on 1-3 axes
  against the JAX path and on 4 axes against the numpy (scipy) path, 1e-5.
- ``grid_pull``: orders 0 (exact) and 1 (1e-5) x bounds zeros, border, reflection on 2-,
  3- and 4-axis grids.
- The bilateral grid: 2-D against JAX, 1e-5; 3-D against the same splat, blur and slice
  composed from the JAX package's numpy paths (its own 3-D grid raises), 1e-5.
- ``phl_filter``: the exact path, the feature grid (F = 2, 4) and the permutohedral
  lattice (F = 6, 1e-4: segment sums in another order), 1e-5.
- The trainable filters: JAX parameters through ``filter_state_dict_from_jax``; forward
  1e-5 and the gradient of sum(out^2) in both sigmas 1e-4 relative (torch autograd
  against ``jax.grad``).
- The stencil wrapper's refusals.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from monai_tpu.networks.layers.filtering import TrainableBilateralFilter as JaxTrainable
from monai_tpu.networks.layers.filtering import TrainableJointBilateralFilter as JaxJoint
from monai_tpu.ops import filtering as jax_filtering
from monai_tpu.ops import gaussian as jax_gaussian
from monai_tpu.ops.pallas_filtering import bilateral_filter_pallas
from monai_tpu.ops.resample import grid_pull as jax_grid_pull
from monai_tpu_torch.networks import filter_state_dict_from_jax
from monai_tpu_torch.networks.layers import (BilateralFilter, PHLFilter, TrainableBilateralFilter,
                                             TrainableJointBilateralFilter)
from monai_tpu_torch.ops import bilateral_stencil, bilateral_stencil_plain
from monai_tpu_torch.ops import filtering as torch_filtering
from monai_tpu_torch.ops.gaussian import gaussian_1d, gaussian_filter, separable_filtering
from monai_tpu_torch.ops.resample import grid_pull

T = torch.from_numpy


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


def _close(got, ref, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


# (shape, spatial sigma, color sigma); radius = max(int(2 sigma + 0.5), 1)
STENCIL_CASES = [
    ((1, 1, 37, 100), 1.5, 0.3),     # tests/test_pallas_kernels.py's shapes
    ((2, 2, 64, 64), 2.0, 0.3),
    ((1, 1, 9, 20, 100), 1.0, 0.3),
    ((3, 2, 17, 19), 1.2, 0.5),      # B·C = 6, odd sizes
    ((2, 3, 5, 6, 7), 0.6, 0.2),     # 3-D, B·C = 6, r = 1
    ((1, 2, 3, 4), 1.5, 0.4),        # sizes <= r = 3
    ((1, 1, 2, 3, 2), 1.0, 0.4),     # 3-D sizes <= r = 2
]
BEYOND_CAPS = [((1, 2, 20, 23), 3.5, 0.3),    # 2-D r = 7 > 6
               ((1, 1, 8, 9, 10), 1.5, 0.3)]  # 3-D r = 3 > 2


def _check_stencil(x, ss, cs, ref):
    _close(bilateral_stencil_plain(T(x), ss, cs), ref, 1e-5)
    _close(torch_filtering.bilateral_filter(T(x), ss, cs), ref, 1e-5)
    _close(BilateralFilter.apply(T(x), ss, cs, fast_approx=False), ref, 1e-5)


@pytest.mark.parametrize("shape,ss,cs", STENCIL_CASES[3:] + BEYOND_CAPS + [((2, 1, 50), 2.0, 0.3), ((1, 3, 7), 4.0, 0.5)])
def test_stencil_matches_xla(shape, ss, cs):
    x = _rand(0, *shape)
    _check_stencil(x, ss, cs, jax_filtering.bilateral_filter(jnp.asarray(x), ss, cs))


@pytest.mark.parametrize("shape,ss,cs", STENCIL_CASES[:3])
def test_stencil_matches_pallas_interpret(shape, ss, cs):
    """The Pallas tests' shapes, where the Pallas kernel (interpret mode) is the oracle:
    it is numerically the XLA stencil, which the other cases hold the port to."""
    x = _rand(1, *shape)
    ref = bilateral_filter_pallas(jnp.asarray(x), ss, cs)
    assert ref is not None
    _check_stencil(x, ss, cs, ref)


def test_stencil_keeps_the_input_type():
    x = T(_rand(2, 1, 1, 12, 13)).to(torch.bfloat16)
    out = bilateral_stencil_plain(x, 1.0, 0.3)
    assert out.dtype == torch.bfloat16
    _close(out.float(), bilateral_stencil_plain(x.float(), 1.0, 0.3).to(torch.bfloat16).float(), 0)


def test_stencil_wrapper_refuses():
    with torch.inference_mode():
        with pytest.raises(ValueError, match="CUDA"):
            bilateral_stencil(torch.zeros(1, 1, 8, 8))
        for shape in [(1, 1, 8), (1, 1, 2, 3, 4, 5)]:  # spatial rank 1 and 4
            with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
                bilateral_stencil(torch.zeros(shape))
    with pytest.raises(RuntimeError, match="forward-only"):
        bilateral_stencil(torch.zeros(1, 1, 8, 8, requires_grad=True))


@pytest.mark.parametrize("approx", ["erf", "sampled", "scalespace"])
@pytest.mark.parametrize("sigma", [0.4, 1.0, 2.7])
@pytest.mark.parametrize("normalize", [True, False])
def test_gaussian_1d(approx, sigma, normalize):
    ref = jax_gaussian.gaussian_1d(sigma, 3.0, approx, normalize)
    got = gaussian_1d(sigma, 3.0, approx, normalize)
    assert got.dtype == np.float32 and got.shape == ref.shape
    _close(got, ref, 1e-7)


MODES = ["zeros", "reflect", "symmetric", "replicate", "circular"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spatial", [(23,), (9, 11), (6, 7, 8), (5, 6, 4, 7)])
def test_separable_filtering(mode, spatial):
    x = _rand(3, 2, *spatial)
    rng = np.random.RandomState(4)
    kernels = [rng.rand(k).astype(np.float32) for k in (3, 5, 1, 4)[:len(spatial)]]
    # the JAX path's conv helper takes at most 3 axes; its numpy (scipy) path any number
    ref = jax_gaussian.separable_filtering(x if len(spatial) == 4 else jnp.asarray(x), kernels, mode)
    _close(separable_filtering(T(x), kernels, mode), ref, 1e-5)


@pytest.mark.parametrize("spatial,sigma", [((30,), 1.5), ((12, 14), (0.8, 2.0)), ((7, 9, 8), 1.0),
                                           ((6, 5, 7, 6), (1.0, 0.0, 0.7, 1.3))])
def test_gaussian_filter(spatial, sigma):
    x = _rand(5, 2, *spatial)
    ref = jax_gaussian.gaussian_filter(x if len(spatial) == 4 else jnp.asarray(x), sigma)
    _close(gaussian_filter(T(x), sigma), ref, 1e-5)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("bound", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("in_spatial", [(7, 9), (6, 5, 8), (5, 4, 6, 3)])
def test_grid_pull(order, bound, in_spatial):
    img = _rand(6, 2, *in_spatial)
    rng = np.random.RandomState(7)
    # coordinates from 2 voxels before the first to 2 after the last, with exact
    # integers and half-voxel ties among them
    grid = rng.uniform(0.0, 1.0, (9, 8, len(in_spatial))) * (np.array(in_spatial) + 3) - 2
    grid[0] = np.round(grid[0] * 2) / 2
    grid = grid.astype(np.float32)
    ref = jax_grid_pull(jnp.asarray(img), jnp.asarray(grid), order, bound)
    got = grid_pull(T(img), T(grid), order, bound)
    if order == 0:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _close(got, ref, 1e-5)


def test_grid_pull_refuses_other_orders_and_bounds():
    img, grid = torch.zeros(1, 4, 4), torch.zeros(3, 2)
    for order, bound in [(3, "zeros"), (1, "dct1"), ("linear", "border")]:
        with pytest.raises(NotImplementedError, match="Native ops"):
            grid_pull(img, grid, order, bound)


@pytest.mark.parametrize("shape,ss,cs", [((2, 1, 20, 24), 2.0, 0.3), ((1, 2, 17, 13), 1.0, 0.05)])
def test_bilateral_grid_2d(shape, ss, cs):
    x = _rand(10, *shape)
    ref = jax.jit(functools.partial(jax_filtering.bilateral_grid_filter, spatial_sigma=ss, color_sigma=cs))(
        jnp.asarray(x))
    _close(torch_filtering.bilateral_grid_filter(T(x), ss, cs), ref, 1e-5)
    _close(BilateralFilter()(T(x), ss, cs), ref, 1e-5)  # fast_approx by default


def _numpy_grid_filter(img: np.ndarray, ss: float, cs: float, grid_pad: int = 2) -> np.ndarray:
    """The bilateral grid from the JAX package's numpy paths: np.add.at splat, its scipy
    ``gaussian_filter``, its numpy ``grid_pull``. monai_tpu's own ``bilateral_grid_filter``
    raises on every 3-D input: the intensity axis makes the blur 4-axis, and its
    ``gaussian_filter`` builds the conv dimension numbers from "DHW"[3 - D:]
    (ops/gaussian.py:74), which has no fourth axis."""
    spatial = img.shape[2:]
    s_rate, c_rate = max(ss, 1.0), max(cs, 1e-3)
    dims = tuple(int(np.ceil(s / s_rate)) + 2 * grid_pad for s in spatial) + (int(np.ceil(1.0 / c_rate)) + 2 * grid_pad,)
    mesh = list(np.meshgrid(*[np.arange(s, dtype=np.float32) / np.float32(s_rate) + np.float32(grid_pad)
                              for s in spatial], indexing="ij"))
    out = []
    for x in img.reshape(-1, *spatial):
        mn = x.min()
        zc = (x - mn) / np.maximum(x.max() - mn, np.float32(1e-8)) / np.float32(c_rate) + np.float32(grid_pad)
        idx = np.ravel_multi_index([np.round(m).astype(np.int64) for m in mesh + [zc]], dims).ravel()
        grid = np.zeros((2, int(np.prod(dims))), np.float32)
        np.add.at(grid[0], idx, x.ravel())
        np.add.at(grid[1], idx, np.float32(1.0))
        blurred = jax_gaussian.gaussian_filter(grid.reshape((2, *dims)), sigma=1.0)
        vals = jax_grid_pull(blurred, np.stack(mesh + [zc], axis=-1), interpolation=1, bound="border")
        out.append(vals[0] / np.maximum(vals[1], 1e-8))
    return np.stack(out).reshape(img.shape)


@pytest.mark.parametrize("shape,ss,cs", [((1, 2, 10, 12, 9), 2.0, 0.3), ((1, 1, 14, 9, 11), 1.0, 0.5),
                                         ((2, 1, 16, 18), 2.0, 0.3)])
def test_bilateral_grid_against_numpy_paths(shape, ss, cs):
    x = _rand(11, *shape)
    ref = _numpy_grid_filter(x, ss, cs)
    if len(shape) == 4:  # where the JAX package runs, the composition is its grid
        jax_grid = jax.jit(functools.partial(jax_filtering.bilateral_grid_filter, spatial_sigma=ss, color_sigma=cs))
        _close(ref, jax_grid(jnp.asarray(x)), 1e-5)
    _close(torch_filtering.bilateral_grid_filter(T(x), ss, cs), ref, 1e-5)


def test_phl_exact_path():
    data, feat = _rand(12, 1, 2, 8, 8), _rand(13, 1, 3, 8, 8)
    sigmas = (0.5, 2.0, 1.5)
    ref = jax_filtering.phl_filter(jnp.asarray(data), jnp.asarray(feat), sigmas)
    _close(PHLFilter.apply(T(data), T(feat), sigmas), ref, 1e-5)


@pytest.mark.parametrize("f,atol", [(2, 1e-5), (4, 1e-5), (6, 1e-4)])
def test_phl_grid_and_lattice(f, atol):
    """N = 17^3 = 4913 > 4096: the feature grid for F <= 5, the permutohedral lattice beyond."""
    spatial = (17, 17, 17)
    data, feat = _rand(14, 1, 2, *spatial), _rand(15, 1, f, *spatial, scale=4.0)
    ref = jax.jit(jax_filtering.phl_filter)(jnp.asarray(data), jnp.asarray(feat))
    _close(torch_filtering.phl_filter(T(data), T(feat)), ref, atol)


def test_phl_grid_forced_small():
    data, feat = _rand(16, 2, 1, 10, 10), _rand(17, 2, 2, 10, 10, scale=4.0)
    ref = jax.jit(jax_filtering._phl_grid_filter, static_argnums=2)(jnp.asarray(data), jnp.asarray(feat), 100)
    _close(torch_filtering._phl_grid_filter(T(data), T(feat), 100), ref, 1e-5)


def _jax_params(f) -> dict:
    return {".".join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.state(f, nnx.Param).flat_state()}


@pytest.mark.parametrize("shape,sigma,joint", [
    ((2, 1, 9, 11), 1.2, False),                # radius 2
    ((1, 2, 5, 6, 7), (0.6, 0.7, 0.8), False),  # radii (1, 1, 2)
    ((2, 1, 9, 11), (0.9, 1.4), True),          # radii (2, 3)
    ((1, 2, 5, 6, 7), 0.6, True),               # radius 1
])
def test_trainable_filters(shape, sigma, joint):
    x, g = _rand(18, *shape), _rand(19, *shape)
    jax_f = (JaxJoint if joint else JaxTrainable)(spatial_sigma=sigma, color_sigma=0.35)
    f = (TrainableJointBilateralFilter if joint else TrainableBilateralFilter)(sigma, device="cpu")
    f.load_state_dict(filter_state_dict_from_jax(_jax_params(jax_f)))
    args = (jnp.asarray(x), jnp.asarray(g)) if joint else (jnp.asarray(x),)

    def loss(m):
        out = m(*args)
        return jnp.sum(out ** 2), out

    (_, ref), grads = nnx.value_and_grad(loss, has_aux=True)(jax_f)
    out = f(*[T(a) for a in ([x, g] if joint else [x])])
    _close(out, ref, 1e-5)
    (out ** 2).sum().backward()
    for name in ("sigma_spatial", "sigma_color"):
        ref_g = np.asarray(grads[name][...])
        got_g = getattr(f, name).grad.numpy()
        np.testing.assert_allclose(got_g, ref_g, rtol=1e-4, atol=1e-4 * np.abs(ref_g).max())


def test_trainable_filter_properties_and_bridge():
    f = TrainableBilateralFilter((1.0, 2.0, 3.0), device="cpu")
    assert f.sigma_spatial.shape == (3,) and [float(s.detach()) for s in (f.sigma_x, f.sigma_y, f.sigma_z)] == [1, 2, 3]
    one = TrainableJointBilateralFilter(1.5, device="cpu")
    assert [float(s.detach()) for s in (one.sigma_x, one.sigma_y, one.sigma_z)] == [1.5] * 3
    sd = filter_state_dict_from_jax(_jax_params(JaxTrainable(spatial_sigma=(1.0, 2.0), color_sigma=0.25)))
    assert sd["sigma_spatial"].shape == (2,) and sd["sigma_color"].shape == () and float(sd["sigma_color"]) == 0.25
    with pytest.raises(KeyError):
        filter_state_dict_from_jax({"sigma_spatial": np.ones(1)})
    with pytest.raises(ValueError, match="Shape"):
        one(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 4, 5))
