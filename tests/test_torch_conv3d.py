"""monai_tpu_torch's 3x3x3 conv against monai_tpu's, on the CPU.

The port's wrapper runs its plain PyTorch version for CPU tensors; it is held to the
JAX Pallas kernel (``_conv3d_pallas_fwd`` in interpret mode, as
tests/test_pallas_conv3d.py runs it) and to the XLA conv, in float32, tolerance 2e-4
(absolute and relative; the sums run in another order). The kernel itself is held to
the plain version on the card, in tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monai_tpu.ops.pallas_conv3d import _conv3d_pallas_fwd, _xla_conv
from monai_tpu_torch.networks.layers.factories import Conv
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MONAI_TPU_PALLAS_INTERPRET", "1")


def _inputs(seed, shape, ci, co):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, ci).astype(np.float32)
    w = (rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)
    return x, w


def _port(x, w, bias=None):
    with torch.inference_mode():
        b = None if bias is None else torch.from_numpy(bias)
        return conv3d_3x3_same(torch.from_numpy(x), torch.from_numpy(w), b).numpy()


@pytest.mark.parametrize("shape,ci,co", [
    ((2, 4, 8, 8), 32, 32),
    ((1, 6, 6, 6), 64, 32),
    ((2, 4, 6, 10), 128, 128),
    ((1, 3, 5, 7), 16, 24),
    ((1, 5, 6, 7), 2, 2),
])
def test_conv_matches_pallas_and_xla(shape, ci, co):
    x, w = _inputs(0, shape, ci, co)
    got = _port(x, w)
    np.testing.assert_allclose(got, np.asarray(_conv3d_pallas_fwd(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(got, np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(w))), **TOL)


def test_conv_bias_matches_xla_plus_bias():
    x, w = _inputs(1, (2, 3, 4, 5), 8, 16)
    bias = np.random.RandomState(2).randn(16).astype(np.float32)
    ref = np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(w))) + bias
    np.testing.assert_allclose(_port(x, w, bias), ref, **TOL)


def test_factory_conv_routes_same_3x3x3_and_matches_nn_conv():
    """The 3-D factory conv sends the SAME 3x3x3 case to the wrapper and equals
    ``F.conv3d`` (its own ``nn.Conv3d`` forward) on a channels-last input."""
    conv = Conv[Conv.CONV, 3](8, 4, kernel_size=3, stride=1, padding=1,
                              generator=torch.Generator().manual_seed(0))
    strided = Conv[Conv.CONV, 3](8, 4, kernel_size=3, stride=2, padding=1)
    assert conv.same_3x3x3 and not strided.same_3x3x3
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 8, 6, 5, 4).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last_3d)
    with torch.inference_mode():
        got = conv(x)
        ref = torch.nn.functional.conv3d(x, conv.weight, conv.bias, padding=1)
    assert got.shape == (2, 4, 6, 5, 4)
    assert got.permute(0, 2, 3, 4, 1).is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_generator_init_is_reproducible_and_torch_scaled():
    a = Conv[Conv.CONV, 3](4, 6, kernel_size=3, padding=1, generator=torch.Generator().manual_seed(5))
    b = Conv[Conv.CONV, 3](4, 6, kernel_size=3, padding=1, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = 1 / np.sqrt(4 * 27)  # torch's default conv init: U(±1/sqrt(fan_in))
    assert a.weight.abs().max() <= bound and a.bias.abs().max() <= bound


@pytest.mark.parametrize("shape,ci,co", [((1, 3, 5, 7), 16, 24), ((2, 4, 4, 4), 1, 24)])
def test_conv_float16_matches_xla_on_the_rounded_inputs(shape, ci, co):
    """float16 in, float16 out: the XLA conv of the same float16 values in float32,
    rounded once to float16 (2^-11 of the value), so 2e-3 of max|ref|."""
    x, w = _inputs(3, shape, ci, co)
    x16, w16 = x.astype(np.float16), w.astype(np.float16)
    with torch.inference_mode():
        got = conv3d_3x3_same(torch.from_numpy(x16), torch.from_numpy(w16))
    assert got.dtype == torch.float16
    ref = np.asarray(_xla_conv(jnp.asarray(x16.astype(np.float32)), jnp.asarray(w16.astype(np.float32))))
    assert np.abs(got.float().numpy() - ref).max() <= 2e-3 * np.abs(ref).max()
