"""monai_tpu_torch's instance norm + PReLU against monai_tpu's, on the CPU.

The port's wrapper runs its plain PyTorch version for CPU tensors; it is held to JAX
``fast_instance_norm`` followed by the JAX ``PReLU``, in float32, tolerance 1e-5
(absolute and relative; the two-moment sums run in another order). The Triton kernel
is held to the plain version on the card, in tests/test_torch_cuda_kernels.py.

Under autograd the wrapper's backward (the backward kernel's plain version here) is held
to ``jax.vjp`` of ``fast_instance_norm`` (its custom rule ``_in_norm_bwd``) followed by
the JAX PReLU, at weights away from 0, 1e-5 of max|ref|; and to torch autograd of the
plain forward at weights of 0 and 1e-4, where JAX's rule, which recovers x^ from the
output by dividing by the weight, is not a sound oracle.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monai_tpu.networks.layers.factories import PReLU
from monai_tpu.networks.layers.fast_norm import fast_instance_norm
from monai_tpu_torch.networks.layers.fast_norm import (InstanceNorm, instance_norm_prelu, instance_norm_prelu_backward,
                                                      instance_norm_prelu_plain)

TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_norm_prelu(x, scale, bias, alpha):
    y = fast_instance_norm(jnp.asarray(x), eps=1e-5,
                           scale=None if scale is None else jnp.asarray(scale),
                           bias=None if bias is None else jnp.asarray(bias))
    if alpha is not None:
        act = PReLU(alpha.shape[0])
        act.alpha.value = jnp.asarray(alpha)
        y = act(y)
    return np.asarray(y)


def _port(x, scale, bias, alpha):
    """x is channels-last (B, *sp, C); the port takes the (B, C, *sp) view of it."""
    xt = torch.from_numpy(x).permute(0, x.ndim - 1, *range(1, x.ndim - 1))
    as_t = (lambda a: None if a is None else torch.from_numpy(a))
    with torch.inference_mode():
        y = instance_norm_prelu(xt, as_t(scale), as_t(bias), as_t(alpha), eps=1e-5)
    return y.permute(0, *range(2, x.ndim), 1).numpy()


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 3), (1, 4, 4, 4, 16), (3, 6, 5, 2)])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("slope", ["none", "one", "per_channel"])
def test_norm_prelu_matches_jax(shape, affine, slope):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.7).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32) if affine else None
    bias = rng.randn(c).astype(np.float32) if affine else None
    alpha = {"none": None, "one": np.full((1,), 0.25, np.float32),
             "per_channel": rng.rand(c).astype(np.float32)}[slope]
    np.testing.assert_allclose(_port(x, scale, bias, alpha), _jax_norm_prelu(x, scale, bias, alpha), **TOL)


def test_norm_module_matches_jax_and_has_torch_param_names():
    x = np.random.RandomState(1).randn(2, 4, 5, 6, 8).astype(np.float32)
    plain, affine = InstanceNorm(8), InstanceNorm(8, affine=True)
    assert list(plain.state_dict()) == [] and list(affine.state_dict()) == ["weight", "bias"]
    with torch.inference_mode():
        got = plain(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(fast_instance_norm(jnp.asarray(x))), **TOL)


def test_constant_channel_gives_zero_not_nan():
    """A constant channel has Σx²/n − m² <= 0 in f32; the clamp at 0 keeps it finite."""
    x = np.full((1, 3, 3, 3, 2), 3.0, np.float32)
    got = _port(x, None, None, None)
    np.testing.assert_allclose(got, _jax_norm_prelu(x, None, None, None), **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("affine", [False, True])
def test_norm_prelu_float16_matches_jax_on_the_rounded_input(affine):
    """float16 in, float16 out, float32 statistics: JAX on the same float16 values in
    float32, rounded once to float16 (2^-11 of the value), so 2e-3 of max|ref|."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 6, 7, 8) * 2 + 0.7).astype(np.float16)
    scale = (rng.rand(8) + 0.5).astype(np.float16) if affine else None
    bias = rng.randn(8).astype(np.float16) if affine else None
    alpha = np.full((1,), 0.25, np.float16)
    got = _port(x, scale, bias, alpha)
    assert got.dtype == np.float16
    f32 = (lambda a: None if a is None else a.astype(np.float32))
    ref = _jax_norm_prelu(f32(x), f32(scale), f32(bias), f32(alpha))
    assert np.abs(got.astype(np.float32) - ref).max() <= 2e-3 * np.abs(ref).max()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _cl(a):
    """(B, *sp, C) numpy -> the port's (B, C, *sp) view."""
    return torch.from_numpy(a).permute(0, a.ndim - 1, *range(1, a.ndim - 1))


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 3), (1, 4, 4, 4, 16)])
@pytest.mark.parametrize("slope", ["one", "per_channel"])
def test_norm_vjp_matches_jax_rule(shape, slope):
    rng = np.random.RandomState(2)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.7).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    alpha = np.full((1,), 0.25, np.float32) if slope == "one" else rng.rand(c).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)

    def jax_fn(x, scale, bias, alpha):
        y = fast_instance_norm(x, eps=1e-5, scale=scale, bias=bias)
        a = alpha if alpha.shape[0] == 1 else alpha.reshape((1,) * (x.ndim - 1) + (-1,))
        return jnp.where(y >= 0, y, a * y)

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (x, scale, bias, alpha)))
    refs = vjp(jnp.asarray(g))
    ts = [_cl(x).requires_grad_()] + [torch.from_numpy(a).requires_grad_() for a in (scale, bias, alpha)]
    got = torch.autograd.grad(instance_norm_prelu(*ts), ts, _cl(g))
    assert _rel(got[0].permute(0, *range(2, x.ndim), 1).numpy(), refs[0]) <= 1e-5
    for a, r in zip(got[1:], refs[1:]):
        assert _rel(a.numpy(), r) <= 1e-5


@pytest.mark.parametrize("gamma", [0.0, 1e-4, 0.7])
@pytest.mark.parametrize("slope", [None, "one"])
def test_norm_vjp_matches_torch_autograd_of_the_plain_forward(gamma, slope):
    """At a weight of 0 the output holds no x^; the port saves x and its statistics, so
    the weight's grad, the sum of gz x^, still comes out."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(2, 4, 5, 6, 7) * 2 + 0.7).astype(np.float32)).requires_grad_()
    w = torch.full((4,), gamma).requires_grad_()
    b = torch.from_numpy(rng.randn(4).astype(np.float32)).requires_grad_()
    a = None if slope is None else torch.full((1,), 0.25).requires_grad_()
    g = torch.from_numpy(rng.randn(2, 4, 5, 6, 7).astype(np.float32))
    params = [t for t in (x, w, b, a) if t is not None]
    got = torch.autograd.grad(instance_norm_prelu(x, w, b, a), params, g)
    ref = torch.autograd.grad(instance_norm_prelu_plain(x, w, b, a), params, g)
    for t, r in zip(got, ref):
        assert torch.isfinite(t).all()
        if r.abs().max() > 0:
            assert _rel(t.numpy(), r.numpy()) <= 1e-5
        else:
            assert t.abs().max() == 0
    assert got[1].abs().max() > 0  # the weight's grad at gamma = 0


def test_norm_backward_sums_give_the_parameter_grads():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 5, 4, 4, 4).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 5, 4, 4, 4).astype(np.float32))
    w, b, a = torch.rand(5) + 0.5, torch.randn(5), torch.rand(5)
    m = x.mean((2, 3, 4))
    r = torch.rsqrt(x.var((2, 3, 4), unbiased=False) + 1e-5)
    dx, sums = instance_norm_prelu_backward(g, x, torch.stack((m, r)), w, b, a)
    assert dx.shape == x.shape and sums.shape == (3, 3, 5)
    xs = [t.clone().requires_grad_() for t in (x, w, b, a)]
    ref = torch.autograd.grad(instance_norm_prelu_plain(*xs), xs, g)
    assert _rel(dx.numpy(), ref[0].numpy()) <= 1e-5
    for s, r_ in zip((sums[1].sum(0), sums[0].sum(0), sums[2].sum(0)), ref[1:]):
        assert _rel(s.numpy(), r_.numpy()) <= 1e-5
