"""The port's upsampling against monai_tpu's, on the CPU, in float32: ``interpolate``'s cubic,
area and linear modes against ``jax.image.resize`` (what the JAX ``interpolate`` calls),
``UpSample``'s ``deconv`` and ``pixelshuffle`` modes, ``SubpixelUpsample``, and
``pixelshuffle`` / ``pixelunshuffle``.

Inputs are drawn with numpy from a seed; the JAX modules' weights reach the port through
``segresnet_state_dict_from_jax`` (which maps an ``UpSample``'s and a
``SubpixelUpsample``'s convs). Tolerances, relative to max|ref|: the resize 1e-6 (the JAX
weights are float32, the port's float64 cast to float32, and the sums run in another
order); the convolutions 1e-5 (float32 sums in another order); the shuffles exact (they
only move values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from monai_tpu.networks import utils as jax_utils
from monai_tpu.networks.blocks import upsample as jax_upsample
from monai_tpu_torch.networks import utils
from monai_tpu_torch.networks.blocks import SubpixelUpsample, UpSample, interpolate
from monai_tpu_torch.networks.blocks.upsample import _resize_weights
from monai_tpu_torch.networks.weights import segresnet_state_dict_from_jax

TOL_RESIZE, TOL_CONV = 1e-6, 1e-5


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _to_last(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 1, -1)


def _abstract(make, seed: int) -> tuple:
    """An nnx module built abstractly and given weights from numpy (biases not 0, so a
    mis-mapped one shows); returns it and {path: array} of its parameters."""
    module = nnx.eval_shape(make)
    rng = np.random.RandomState(seed)
    params = {}
    for path, var in nnx.state(module, nnx.Param).flat_state():
        shape = var.get_value().shape
        a = (rng.uniform(-0.2, 0.2, shape) if path[-1] == "bias"
             else rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        var.set_value(jnp.asarray(a))
        params[".".join(map(str, path))] = a
    return module, params


def _jax_apply(module, x: np.ndarray) -> np.ndarray:
    """The channel-last JAX module on a channel-first input, compiled as one program."""
    graphdef, state = nnx.split(module)
    y = jax.jit(lambda s, a: nnx.merge(graphdef, s)(a))(state, jnp.asarray(_to_last(x)))
    return np.moveaxis(np.asarray(y), -1, 1)


# --- interpolate against jax.image.resize ------------------------------------------------

RESIZES = [((7, 9), (4, 13)), ((9, 5), (3, 2)), ((5, 6, 7), (11, 3, 7)), ((8, 5, 9), (3, 10, 4)),
           ((4, 6, 5), (9, 13, 11))]


@pytest.mark.parametrize("mode", ["bicubic", "area", "linear"])
@pytest.mark.parametrize("size_in,size_out", RESIZES, ids=[f"{a}->{b}" for a, b in RESIZES])
def test_interpolate_matches_jax_resize(mode, size_in, size_out):
    """Odd sizes, each axis enlarged, shrunk or kept; the JAX ``interpolate`` maps bicubic
    to Keys' cubic and area to the antialiased linear."""
    x = _rand(0, 2, 3, *size_in)
    want = np.asarray(jax_upsample.interpolate(jnp.asarray(_to_last(x)), size=size_out, mode=mode))
    want = np.moveaxis(want, -1, 1)
    got = interpolate(torch.from_numpy(x), size=size_out, mode=mode).numpy()
    assert _rel(got, want) <= TOL_RESIZE


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("n_in,n_out", [(7, 3), (5, 12), (9, 4), (6, 6), (3, 10)])
def test_resize_weights_equal_jax_matrix(method, n_in, n_out):
    """The per-axis matrix, applied to the identity, against ``jax.image.resize`` of the
    identity (a column a source sample): border renormalisation, samples outside
    [-0.5, in - 0.5] zeroed, the kernel widened on shrink."""
    eye = np.eye(n_in, dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(eye), (n_in, n_out), method=method))
    got = _resize_weights(n_in, n_out, method == "cubic")
    assert np.abs(got - want).max() <= TOL_RESIZE


def test_interpolate_enlarging_linear_keeps_its_route():
    """A linear mode that enlarges every axis is still ``F.interpolate``'s, equal to the
    weight matrices within float32 rounding."""
    x = torch.from_numpy(_rand(1, 1, 2, 5, 6, 7))
    got = interpolate(x, scale_factor=2, mode="trilinear")
    want = jax_upsample.interpolate(jnp.asarray(_to_last(x.numpy())), scale_factor=2, mode="trilinear")
    assert _rel(got.numpy(), np.moveaxis(np.asarray(want), -1, 1)) <= TOL_RESIZE


# --- UpSample's deconv and pixelshuffle modes, SubpixelUpsample --------------------------

@pytest.mark.parametrize("dims,kernel,scale", [(3, None, 2), (3, 3, 2), (2, 3, 2), (2, None, 3), (2, 1, 2), (2, 4, 2)])
def test_upsample_deconv_matches_jax(dims, kernel, scale):
    """kernel = stride (the default), and kernel 3 at stride 2, whose JAX "SAME" output is
    2n where torch's unpadded one is 2n + 1; kernel 1 at stride 2 (the output padded past
    torch's) and kernel 4."""
    spatial = (5, 6, 7)[:dims]
    ref, params = _abstract(lambda: jax_upsample.UpSample(dims, 4, 3, scale, kernel_size=kernel, mode="deconv",
                                                          rngs=nnx.Rngs(0)), 0)
    port = UpSample(dims, 4, 3, scale, kernel_size=kernel, mode="deconv")
    port.load_state_dict(segresnet_state_dict_from_jax(params), strict=True)
    x = _rand(2, 2, 4, *spatial)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 3, *(s * scale for s in spatial))
    assert _rel(got, _jax_apply(ref, x)) <= TOL_CONV


@pytest.mark.parametrize("dims,scale", [(3, 2), (2, 2), (2, 3)])
def test_upsample_pixelshuffle_matches_jax(dims, scale):
    """UpSample's pixelshuffle mode (``SubpixelUpsample`` with its default 3x3 SAME conv,
    a kernel-1 site in 3-D), channel order the JAX module's."""
    spatial = (5, 4, 3)[:dims]
    ref, params = _abstract(lambda: jax_upsample.UpSample(dims, 4, 3, scale, mode="pixelshuffle", rngs=nnx.Rngs(1)), 1)
    port = UpSample(dims, 4, 3, scale, mode="pixelshuffle")
    port.load_state_dict(segresnet_state_dict_from_jax(params), strict=True)
    x = _rand(3, 2, 4, *spatial)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 3, *(s * scale for s in spatial))
    assert _rel(got, _jax_apply(ref, x)) <= TOL_CONV


def test_subpixel_upsample_without_conv_is_the_jax_shuffle():
    """No conv: the shuffle alone, exact, and not ``pixelshuffle``'s channel order."""
    x = _rand(4, 2, 16, 3, 2, 5)
    ref = jax_upsample.SubpixelUpsample(3, 2, 2, 2, conv_block=None, rngs=nnx.Rngs(0))
    want = np.moveaxis(np.asarray(ref(jnp.asarray(_to_last(x)))), -1, 1)
    got = SubpixelUpsample(3, 2, 2, 2, conv_block=None)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, utils.pixelshuffle(torch.from_numpy(x), 3, 2).numpy())


@pytest.mark.parametrize("dims,factor", [(2, 2), (3, 2), (2, 3), (1, 4)])
def test_pixelshuffle_and_unshuffle_equal_jax(dims, factor):
    x = _rand(5, 2, 3 * factor**dims, *(2, 3, 4)[:dims])
    want = np.asarray(jax_utils.pixelshuffle(jnp.asarray(x), dims, factor))
    got = utils.pixelshuffle(torch.from_numpy(x), dims, factor)
    np.testing.assert_array_equal(got.numpy(), want)
    back = utils.pixelunshuffle(got, dims, factor)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_utils.pixelunshuffle(jnp.asarray(want), dims, factor)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_pixelshuffle_rejects_indivisible_channels():
    with pytest.raises(ValueError):
        utils.pixelshuffle(torch.zeros(1, 6, 2, 2), 2, 2)
    with pytest.raises(ValueError):
        utils.pixelunshuffle(torch.zeros(1, 1, 3, 4), 2, 2)
