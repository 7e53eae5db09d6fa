"""monai_tpu_torch's fused window attention against monai_tpu's, on the CPU.

The port's wrapper runs its plain PyTorch version for CPU tensors; it is held to the
JAX ``fused_window_attention``, whose Pallas kernel runs in interpret mode on the CPU,
in float32 at atol 1e-5 (as tests/test_pallas_window_attention.py holds the kernel to
the XLA formulation), and in bfloat16 at 1e-2 of max|ref| (both round p and the output
to bfloat16, and may differ by one bfloat16 step). ``WindowAttention`` is held to the
JAX module with the Pallas path forced on. The kernel itself is held to the plain
version on the card, in tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from monai_tpu.networks.nets.swin_unetr import WindowAttention as JaxWindowAttention
from monai_tpu.ops import pallas_window_attention as pwa
from monai_tpu_torch.networks.nets.swin_unetr import WindowAttention
from monai_tpu_torch.ops.window_attention import (fused_window_attention, fused_window_attention_plain,
                                                  window_attention_plan)


def _inputs(seed, b, h, n, d, nw):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    bias = (rng.randn(h, n, n) * 0.5).astype(np.float32)
    mask = (rng.rand(nw, n, n) > 0.5).astype(np.float32) * -100.0 if nw else None
    return q, k, v, bias, mask


def _port(q, k, v, bias, mask, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with torch.inference_mode():
        return fused_window_attention(*(a.to(dtype) for a in t), torch.from_numpy(bias),
                                      None if mask is None else torch.from_numpy(mask))


def _jax(q, k, v, bias, mask, dtype=jnp.float32):
    return pwa.fused_window_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(bias),
                                      None if mask is None else jnp.asarray(mask))


@pytest.mark.parametrize("b,h,n,d,nw", [
    (12, 3, 27, 8, 4),     # masked, a window of 3^3
    (12, 3, 27, 8, 0),     # no mask
    (4, 2, 343, 8, 2),     # a full 7^3 window, masked
    (3, 4, 216, 8, 0),     # the 6^3 window that stage 4 clamps to, no mask
    (6, 2, 64, 16, 3),     # head dim 16 (feature size 48)
    (6, 2, 64, 32, 2),     # head dim 32, 3 windows a mask row: the card's tensor-core instance at its widest
])
def test_matches_jax_pallas_kernel_f32(b, h, n, d, nw):
    args = _inputs(b + n + nw, b, h, n, d, nw)
    got = _port(*args)
    assert got.shape == (b, h, n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax(*args)), atol=1e-5)


@pytest.mark.parametrize("nw", [0, 4])
def test_matches_jax_pallas_kernel_bf16(nw):
    args = _inputs(3, 8, 3, 27, 8, nw)
    got = _port(*args, dtype=torch.bfloat16)
    ref = np.asarray(_jax(*args, dtype=jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


def test_plain_rounds_p_to_the_input_dtype():
    """In bfloat16, p is rounded before p.v: the plain version equals that float32
    formula exactly, and differs from keeping p in float32."""
    q, k, v, bias, mask = (torch.from_numpy(a) for a in _inputs(4, 4, 2, 27, 8, 2))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    s = qb.float() @ kb.float().transpose(-1, -2) + bias
    s = (s.view(2, 2, 2, 27, 27) + mask[None, :, None]).view(4, 2, 27, 27)
    p = torch.softmax(s, -1)
    rounded = (p.bfloat16().float() @ vb.float()).bfloat16()
    got = fused_window_attention_plain(qb, kb, vb, bias, mask)
    assert torch.equal(got, rounded)
    assert not torch.equal(got, (p @ vb.float()).bfloat16())


def test_cpu_routing_counts_no_launch():
    before = fused_window_attention.launches
    got = _port(*_inputs(5, 4, 2, 27, 8, 2))
    assert fused_window_attention.launches == before
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("change,error", [
    (dict(q=torch.zeros(4, 2, 27)), ValueError),                                # q not 4-D
    (dict(k=torch.zeros(4, 2, 27, 4)), ValueError),                             # shapes differ
    (dict(q=torch.zeros(4, 2, 27, 8, dtype=torch.float64)), TypeError),         # dtype
    (dict(v=torch.zeros(4, 2, 27, 8, dtype=torch.bfloat16)), TypeError),        # mixed dtypes
    (dict(bias=torch.zeros(2, 27, 27, dtype=torch.bfloat16)), ValueError),      # bias not f32
    (dict(bias=torch.zeros(3, 27, 27)), ValueError),                            # bias heads
    (dict(mask=torch.zeros(3, 27, 27)), ValueError),                            # 4 % 3 != 0
    (dict(mask=torch.zeros(2, 27, 26)), ValueError),                            # mask shape
    (dict(q=torch.zeros(4, 27, 2, 8).transpose(1, 2)), ValueError),             # not contiguous
])
def test_wrapper_rejects_unsupported(change, error):
    args = dict(q=torch.zeros(4, 2, 27, 8), k=torch.zeros(4, 2, 27, 8), v=torch.zeros(4, 2, 27, 8),
                bias=torch.zeros(2, 27, 27), mask=None)
    args.update(change)
    with torch.inference_mode(), pytest.raises(error):
        fused_window_attention(**args)


def test_plan_describes_only_cuda_launches():
    q = torch.zeros(4, 2, 27, 8)
    with pytest.raises(ValueError, match="CUDA"):
        window_attention_plan(q, q, q, torch.zeros(2, 27, 27))


def test_wrapper_refuses_grad():
    """The wrapper takes a first derivative (the JAX custom VJP's; its backward is held in
    tests/test_torch_window_attention_bwd.py) and refuses a second: its backward kernels
    have none."""
    q = torch.zeros(4, 2, 27, 8, requires_grad=True)
    out = fused_window_attention(q, q.detach(), q.detach(), torch.zeros(2, 27, 27))
    (dq,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    assert dq.shape == q.shape
    with pytest.raises(RuntimeError):
        dq.sum().backward()


@pytest.mark.parametrize("window,n_tokens,with_mask", [((3, 3, 3), 27, True), ((3, 3, 3), 27, False),
                                                       ((7, 7, 7), 216, False)])
def test_window_attention_module_matches_jax_kernel_path(monkeypatch, window, n_tokens, with_mask):
    """``WindowAttention`` against the JAX module forced onto the Pallas kernel; 216
    tokens under a 7^3 window is stage 4's clamp, which reads the bias index [:n, :n]."""
    monkeypatch.setattr(pwa, "use_pallas_window_attention", lambda: True)
    jax_attn = JaxWindowAttention(dim=24, num_heads=3, window_size=window, qkv_bias=True, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(2)
    for _, var in nnx.state(jax_attn, nnx.Param).flat_state():  # nnx's zero biases would hide a mis-map
        var.set_value(jnp.asarray(rng.randn(*var.get_value().shape).astype(np.float32) * 0.2))
    port = WindowAttention(24, 3, window, qkv_bias=True).eval()
    sd = {"relative_position_bias_table": torch.tensor(np.asarray(jax_attn.relative_position_bias_table[...])),
          "relative_position_index": torch.tensor(np.asarray(jax_attn.relative_position_index[...]), dtype=torch.int64),
          "qkv.weight": torch.tensor(np.asarray(jax_attn.qkv.kernel[...]).T),
          "qkv.bias": torch.tensor(np.asarray(jax_attn.qkv.bias[...])),
          "proj.weight": torch.tensor(np.asarray(jax_attn.proj.kernel[...]).T),
          "proj.bias": torch.tensor(np.asarray(jax_attn.proj.bias[...]))}
    port.load_state_dict(sd)
    x = rng.randn(8, n_tokens, 24).astype(np.float32)
    mask = (rng.rand(4, n_tokens, n_tokens) > 0.5).astype(np.float32) * -100.0 if with_mask else None
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    ref = jax_attn(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [4, 12, 20])
@pytest.mark.parametrize("n", [27, 729])
@pytest.mark.parametrize("nw", [0, 2])
def test_any_head_dim_and_window_matches_jax_pallas_kernel(d, n, nw):
    """Head dims and windows beyond the card kernel's fast instances (D in 8, 16, 32;
    N <= 512): its generic instance is held to this same plain version on the card."""
    b = 2 if n > 512 else 4
    args = _inputs(d + n + nw, b, 2, n, d, nw)
    got = fused_window_attention_plain(*(torch.from_numpy(a) if a is not None else None for a in args))
    assert got.shape == (b, 2, n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax(*args)), atol=1e-5)


@pytest.mark.parametrize("nw", [0, 4])
def test_matches_jax_pallas_kernel_f16(nw):
    """float16: both round p and the output to float16 (a step of 2^-11 of the value), so
    they may differ by one float16 step: 2e-3 of max|ref|."""
    args = _inputs(6, 8, 3, 27, 12, nw)
    got = _port(*args, dtype=torch.float16)
    ref = np.asarray(_jax(*args, dtype=jnp.float16).astype(jnp.float32))
    assert got.dtype == torch.float16
    assert np.abs(got.float().numpy() - ref).max() <= 2e-3 * np.abs(ref).max()
