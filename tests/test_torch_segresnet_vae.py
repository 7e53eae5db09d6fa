"""The port's SegResNetVAE against monai_tpu's, and the dropouts that the port now takes
(DynUNet's, SwinUNETR's attention dropout), on the CPU, in float32.

- SegResNetVAE (init_filters 8, blocks (1, 2, 2) and (1, 1), 2 input channels, 16^3, 32
  latents), built abstractly and filled from a numpy seed, carried over by
  ``segresnet_state_dict_from_jax``: the JAX net draws its noise with ``jax.random.normal``
  (from ``rngs.params()``), which the test captures with ``monkeypatch`` and feeds to the
  port's ``sample_noise``. The logits within 1e-4 of max|ref| (``nnx.GroupNorm`` takes the
  variance as E[x^2] - E[x]^2, torch about the mean: ~1e-5 of max|ref| here, as in
  ``test_torch_segresnet.py``) and the VAE loss within 1e-5 relative, at both
  ``vae_estimate_std`` values and with ``upsample_mode="deconv"`` (the transposed convs'
  bridge).
- DynUNet at ``dropout=0.3`` in train mode gives what ``dropout=None`` gives, as the JAX
  net, which takes the argument and applies no dropout.
- SwinUNETR (2-D, feature size 12, one block a stage) at ``attn_drop_rate=0.2`` in eval
  mode against the JAX net's (which leaves its kernel for einsum and softmax at any rate
  above 0) within 1e-4 of max|ref|, the port on its kernel's route; in train mode the
  port's window attention takes the plain route, equal to q kᵀ + bias + mask, softmax, the
  dropout mask drawn from a generator of the same seed, and the product with v, computed
  here by einsum, within 1e-6 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from monai_tpu.networks.nets import segresnet as jax_segresnet
from monai_tpu.networks.nets import swin_unetr as jax_swin
from monai_tpu_torch.networks.nets import DynUNet, SegResNetVAE, SwinUNETR
from monai_tpu_torch.networks.nets import swin_unetr
from monai_tpu_torch.networks.utils import generator_on
from monai_tpu_torch.networks.weights import segresnet_state_dict_from_jax, swin_state_dict_from_jax

TOL_LOGITS, TOL_LOSS, TOL_SWIN, TOL_ROUTE = 1e-4, 1e-5, 1e-4, 1e-6
VAE_ARGS = dict(input_image_size=(16, 16, 16), vae_nz=32, spatial_dims=3, init_filters=8, in_channels=2,
                out_channels=3, blocks_down=(1, 2, 2), blocks_up=(1, 1))


def _owner(module, path):
    for t in path:
        module = module[int(t)] if str(t).isdigit() else getattr(module, t)
    return module


def _fill(module, seed: int) -> dict:
    """Give every variable of an abstract nnx module a value drawn with numpy; return
    {path: array} of its parameters (and a Swin net's relative-position indices)."""
    rng = np.random.RandomState(seed)
    params = {}
    for path, var in nnx.state(module).flat_state():
        shape, kind, leaf = var.get_value().shape, type(var).__name__, path[-1]
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
            continue
        if kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
            continue
        if leaf == "relative_position_index":
            a = jax_swin._rel_pos_index(_owner(module, path[:-1]).window_size).astype(np.int32)
        elif leaf == "relative_position_bias_table":
            a = rng.randn(*shape) * 0.5
        elif leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias":
            a = rng.uniform(-0.2, 0.2, shape)
        else:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        a = a if a.dtype == np.int32 else a.astype(np.float32)
        var.set_value(jnp.asarray(a))
        params[".".join(map(str, path))] = a
    return params


# --- SegResNetVAE --------------------------------------------------------------------------

@pytest.mark.parametrize("estimate_std,upsample_mode", [(False, "nontrainable"), (True, "nontrainable"),
                                                        (False, "deconv")])
def test_segresnet_vae_matches_jax(monkeypatch, estimate_std, upsample_mode):
    kw = dict(VAE_ARGS, vae_estimate_std=estimate_std, upsample_mode=upsample_mode)
    ref = nnx.eval_shape(lambda: jax_segresnet.SegResNetVAE(**kw, rngs=nnx.Rngs(0)))
    params = _fill(ref, 0)
    port = SegResNetVAE(**kw, device="cpu")
    port.load_state_dict(segresnet_state_dict_from_jax(params), strict=True)

    draws, normal = [], jax.random.normal

    def captured(key, shape, *args, **kwargs):
        draws.append(normal(key, shape, *args, **kwargs))
        return draws[-1]

    monkeypatch.setattr(jax.random, "normal", captured)
    graphdef, state = nnx.split(ref)
    run = jax.jit(lambda s, a: (*nnx.merge(graphdef, s)(a), draws[-1]))
    x = np.random.RandomState(1).rand(2, 2, 16, 16, 16).astype(np.float32)
    want, want_loss, draw = map(np.asarray, run(state, jnp.asarray(x)))
    assert draw.shape == (2, 32) and len(draws) == 1
    port.sample_noise = lambda like: torch.from_numpy(draw)
    got, got_loss = port.eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 3, 16, 16, 16)
    assert np.abs(got.detach().numpy() - want).max() <= TOL_LOGITS * np.abs(want).max()
    assert abs(got_loss.item() - float(want_loss)) <= TOL_LOSS * abs(float(want_loss))


def test_segresnet_vae_noise_comes_from_its_generator():
    """``sample_noise`` draws N(0, 1) from ``noise_generator``: one seed, one loss; the
    noise is cut from the graph."""
    x = torch.rand(1, 2, 16, 16, 16, generator=torch.Generator().manual_seed(2))
    losses = []
    for seed in (5, 5, 6):
        net = SegResNetVAE(**VAE_ARGS, device="cpu", generator=torch.Generator().manual_seed(0),
                           noise_generator=torch.Generator().manual_seed(seed))
        _, loss = net(x)
        losses.append(loss.item())
    assert losses[0] == losses[1] != losses[2]
    noise = net.sample_noise(torch.zeros(3, 4, requires_grad=True))
    assert noise.shape == (3, 4) and not noise.requires_grad


# --- the dropouts ------------------------------------------------------------------------

def test_dynunet_dropout_is_taken_and_not_applied():
    kw = dict(spatial_dims=3, in_channels=1, out_channels=2, kernel_size=[3, 3, 3], strides=[1, 2, 2],
              upsample_kernel_size=[2, 2], filters=[4, 8, 8], device="cpu")
    x = torch.rand(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(3))
    outs = [DynUNet(**kw, dropout=p, generator=torch.Generator().manual_seed(0)).train()(x) for p in (None, 0.3)]
    assert torch.equal(outs[0], outs[1])


SWIN_KW = dict(in_channels=1, out_channels=3, feature_size=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3),
               spatial_dims=2, attn_drop_rate=0.2)


def test_swin_unetr_attention_dropout_in_eval_matches_jax(monkeypatch):
    ref = nnx.eval_shape(lambda: jax_swin.SwinUNETR(**SWIN_KW, rngs=nnx.Rngs(0)))
    params = _fill(ref, 4)
    ref.eval()
    port = SwinUNETR(**SWIN_KW, device="cpu")
    port.load_state_dict(swin_state_dict_from_jax(params))
    calls = []
    kernel = swin_unetr.fused_window_attention
    monkeypatch.setattr(swin_unetr, "fused_window_attention", lambda *a: calls.append(1) or kernel(*a))
    x = np.random.RandomState(5).rand(2, 1, 32, 32).astype(np.float32)
    graphdef, state = nnx.split(ref)
    want = np.asarray(jax.jit(lambda s, a: nnx.merge(graphdef, s)(a))(state, jnp.asarray(x)))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= TOL_SWIN * np.abs(want).max()
    assert len(calls) == 4  # the kernel's route, one a block


def test_window_attention_dropout_in_train_takes_the_plain_route(monkeypatch):
    g = torch.Generator().manual_seed(6)
    attn = swin_unetr.WindowAttention(12, 3, (4, 4), qkv_bias=True, attn_drop=0.2, generator=g).train()
    monkeypatch.setattr(swin_unetr, "fused_window_attention", None)  # the kernel's route is not taken
    nw, b, n = 4, 8, 16
    x = torch.randn(b, n, 12, generator=g)
    mask = torch.where(torch.rand(nw, n, n, generator=g) < 0.3, -100.0, 0.0)
    attn.dropout_generator = torch.Generator().manual_seed(7)
    got = attn(x, mask)

    q, k, v = attn.qkv(x).reshape(b, n, 3, 3, 4).permute(2, 0, 3, 1, 4)
    idx = attn.relative_position_index[:n, :n].reshape(-1)
    bias = attn.relative_position_bias_table[idx].reshape(n, n, 3).permute(2, 0, 1)
    scores = torch.einsum("bhnd,bhmd->bhnm", q * attn.scale, k) + bias
    scores = (scores.reshape(b // nw, nw, 3, n, n) + mask[None, :, None]).reshape(b, 3, n, n)
    weights = scores.softmax(-1)
    keep = torch.rand(weights.shape, generator=generator_on(torch.Generator().manual_seed(7), weights.device, {}),
                      device=weights.device) >= 0.2
    out = torch.einsum("bhnm,bhmd->bhnd", weights * keep / 0.8, v)
    want = attn.proj(out.transpose(1, 2).reshape(b, n, 12))
    assert (got - want).abs().max().item() <= TOL_ROUTE * want.abs().max().item()
    assert not torch.equal(attn(x, mask), got)  # the next draw drops others


def test_generator_on_a_generators_own_device_is_that_generator():
    """Where the draw's device is the generator's (or there is none), ``generator_on`` gives
    it back and seeds nothing; the card's case is a test in ``test_torch_cuda_kernels.py``."""
    g, made = torch.Generator().manual_seed(1), {}
    assert generator_on(g, torch.device("cpu"), made) is g
    assert generator_on(None, torch.device("cpu"), made) is None and made == {}
    assert g.initial_seed() == 1 and torch.equal(torch.rand(4, generator=g),
                                                 torch.rand(4, generator=torch.Generator().manual_seed(1)))
