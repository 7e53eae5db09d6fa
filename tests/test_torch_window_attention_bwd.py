"""The backward of monai_tpu_torch's fused window attention against monai_tpu's custom
VJP, on the CPU.

On CPU tensors the port's autograd Function runs the plain backward
(``fused_window_attention_backward_plain``); it is held to ``jax.vjp`` of the JAX
``fused_window_attention`` (its Pallas forward in interpret mode, its backward the XLA
recompute of ``_vjp_bwd``): dq, dk, dv and dbias within 1e-5 of each one's max|ref| in
float32 (float32 sums in another order). In bfloat16 the port's grads are held within
1e-2 to the JAX rule run in float32 on the same bfloat16 inputs (the port rounds p and
the grads to bfloat16, about one bfloat16 step; the JAX rule in bfloat16 also rounds the
scores and the softmax to bfloat16 before differentiating, a coarser function). The mask
gets no grad in either. The CUDA
kernel is held to the plain version on the card, in tests/test_torch_cuda_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monai_tpu.ops import pallas_window_attention as pwa
from monai_tpu_torch.ops.window_attention import (fused_window_attention, fused_window_attention_backward,
                                                  fused_window_attention_backward_plain,
                                                  window_attention_backward_plan)


def _inputs(seed, b, h, n, d, nw):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    q *= d ** -0.5
    bias = (rng.randn(h, n, n) * 0.5).astype(np.float32)
    mask = (rng.rand(nw, n, n) > 0.5).astype(np.float32) * -100.0 if nw else None
    g = rng.randn(b, h, n, d).astype(np.float32)
    return q, k, v, bias, mask, g


def _jax_grads(q, k, v, bias, mask, g, dtype=jnp.float32):
    m = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: pwa.fused_window_attention(*a, m), *(jnp.asarray(a, dtype) for a in (q, k, v)),
                     jnp.asarray(bias))
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in vjp(jnp.asarray(g, dtype))]


def _port_grads(q, k, v, bias, mask, g, dtype=torch.float32):
    params = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    params.append(torch.from_numpy(bias).requires_grad_())
    m = None if mask is None else torch.from_numpy(mask)
    before = fused_window_attention_backward.launches
    out = fused_window_attention(*params, m)
    grads = torch.autograd.grad(out, params, torch.from_numpy(g).to(dtype))
    assert fused_window_attention_backward.launches == before  # the CPU runs the plain backward
    assert all(a.dtype == p.dtype for a, p in zip(grads, params))
    return [a.float().numpy() for a in grads]


def _assert_close(got, ref, rel):
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.shape == r.shape, name
        err, scale = np.abs(a - r).max(), np.abs(r).max()
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("b,h,n,d,nw", [
    (12, 3, 27, 8, 4),   # masked, a 3^3 window
    (12, 3, 27, 8, 0),   # no mask
    (4, 2, 343, 16, 2),  # a full 7^3 window at the BTCV bundle's head dim, masked
    (3, 4, 216, 16, 0),  # the 6^3 window of the last stage, no mask
    (6, 2, 64, 4, 3),    # head dim 4 (feature size 12)
    (6, 1, 64, 32, 0),   # head dim 32
])
def test_backward_matches_jax_vjp_f32(b, h, n, d, nw):
    args = _inputs(b * 7 + n + nw, b, h, n, d, nw)
    _assert_close(_port_grads(*args), _jax_grads(*args), 1e-5)


@pytest.mark.parametrize("nw", [0, 4])
def test_backward_in_bf16_matches_jax_vjp_in_f32(nw):
    q, k, v, bias, mask, g = _inputs(5, 8, 3, 64, 16, nw)
    q, k, v, g = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v, g))  # bfloat16 values
    args = (q, k, v, bias, mask, g)
    _assert_close(_port_grads(*args, dtype=torch.bfloat16), _jax_grads(*args), 1e-2)


def test_plain_backward_is_the_rule_on_the_forward_output():
    """``fused_window_attention_backward`` on CPU tensors is the plain version, which
    takes the forward's output for D; the mask takes no grad and a second derivative
    raises (the backward kernels have none)."""
    q, k, v, bias, mask, g = (None if a is None else torch.from_numpy(a) for a in _inputs(1, 4, 2, 27, 8, 2))
    out = fused_window_attention(q, k, v, bias, mask)
    got = fused_window_attention_backward(q, k, v, bias, mask, out, g)
    ref = fused_window_attention_backward_plain(q, k, v, bias, mask, out, g)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    mask.requires_grad_()
    params = [t.requires_grad_() for t in (q, k, v, bias)]
    (gq,) = torch.autograd.grad(fused_window_attention(*params, mask), [q], g, create_graph=True)
    assert mask.grad is None
    with pytest.raises(RuntimeError):
        gq.sum().backward()


def test_backward_plan_describes_only_cuda_launches():
    q = torch.zeros(2, 1, 27, 8)
    with pytest.raises(ValueError, match="CUDA"):
        window_attention_backward_plan(q, q, q, torch.zeros(1, 27, 27))
