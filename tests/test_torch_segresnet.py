"""SegResNet of monai_tpu_torch against monai_tpu's, on the CPU.

The JAX net is built abstractly and filled from a numpy seed (group norm scales and biases
too); ``segresnet_state_dict_from_jax`` carries its parameters into the port. Both run a
``SegResNet(init_filters=8, blocks_down=(1, 2, 2), blocks_up=(1, 1))`` at 32^3, float32.

- The forward, in eval mode: within 1e-4 of max|ref|. ``nnx.GroupNorm`` takes the variance
  as E[x^2] - E[x]^2 (``use_fast_variance``) where torch takes it about the mean; at these
  inputs the two differ by ~1e-5 of max|ref|, which the tolerance takes.
- One step of ``DiceLoss(sigmoid=True, squared_pred=True, smooth_nr=0, smooth_dr=1e-5)``,
  the BraTS bundle's loss: with every ReLU made a LeakyReLU of slope 1 (no kink; every
  backward still runs) the loss within 1e-5 relative and every grad within 1e-3 of its
  max|ref|. With the ReLU as it is, float32 order differences flip ReLU branches and move
  grads by up to ~1e-2 of their max (measured 1.5e-2 at the widest), so each grad is held
  by its cosine with the JAX grad, at least 0.9999, and the loss to 1e-5; then one AdamW
  step (lr 1e-4, weight decay 1e-5, the bundle's rates) against ``optax.adamw``: the first
  step moves a parameter by lr times its grad's sign where the grad is far above Adam's
  eps of 1e-8, so each is held within 1e-6 where its grad is at least 5% of its tensor's
  max|grad| (past the branch flips' reach) and 100 eps, and within 2 lr elsewhere.
- The group norm's group count clamped to the largest divisor of the channels, as the JAX
  factory clamps it, and its output against ``nnx.GroupNorm``; dropout drops elements, as
  ``nnx.Dropout`` does, not channels; ``UpSample`` nearest and linear at an odd size
  against the JAX ``UpSample``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from monai_tpu.losses import DiceLoss as JaxDiceLoss
from monai_tpu.networks.blocks.upsample import UpSample as JaxUpSample
from monai_tpu.networks.layers.factories import Norm as JaxNorm
from monai_tpu.networks.nets.segresnet import SegResNet as JaxSegResNet
from monai_tpu_torch.losses import DiceLoss
from monai_tpu_torch.networks.blocks import UpSample, get_upsample_layer
from monai_tpu_torch.networks.layers.factories import Norm
from monai_tpu_torch.networks.nets import SegResNet
from monai_tpu_torch.networks.weights import segresnet_state_dict_from_jax

ARGS = dict(spatial_dims=3, init_filters=8, in_channels=1, out_channels=3, blocks_down=(1, 2, 2), blocks_up=(1, 1))
LR, WEIGHT_DECAY = 1e-4, 1e-5
NO_KINK = ("leakyrelu", {"negative_slope": 1.0})


def _filled_jax_segresnet(seed: int, **kw):
    """A JAX SegResNet built abstractly, every parameter drawn with numpy; returns the
    module and {path: array}."""
    net = nnx.eval_shape(lambda: JaxSegResNet(**ARGS, **kw, rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(seed)
    params = {}
    for path, var in nnx.state(net).flat_state():
        shape, kind, leaf = var.get_value().shape, type(var).__name__, path[-1]
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
            continue
        if kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
            continue
        if leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias":
            a = rng.uniform(-0.2, 0.2, shape)
        else:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        a = a.astype(np.float32)
        var.set_value(jnp.asarray(a))
        params[".".join(map(str, path))] = a
    return net, params


def _inputs():
    rng = np.random.RandomState(1)
    return (rng.rand(1, 1, 32, 32, 32).astype(np.float32),
            (rng.rand(1, 3, 32, 32, 32) > 0.6).astype(np.float32))


def _step(**kw):
    """(JAX loss, JAX grads, JAX params, port loss, port net) of one step on one batch."""
    net, params = _filled_jax_segresnet(0, **kw)
    x, y = _inputs()
    loss_args = dict(sigmoid=True, squared_pred=True, smooth_nr=0, smooth_dr=1e-5)
    jax_loss = JaxDiceLoss(**loss_args)
    graphdef, state = nnx.split(net)
    param_state, rest = state.split(nnx.Param, ...)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p, a, b: jax_loss(nnx.merge(graphdef, p, rest)(a), b)))(
        param_state, jnp.asarray(x), jnp.asarray(y))
    port = SegResNet(**ARGS, **kw, device="cpu")
    port.load_state_dict(segresnet_state_dict_from_jax(params), strict=True)
    loss = DiceLoss(**loss_args)(port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    return ref_grads, param_state, params, port


def _as_port(state) -> dict:
    return segresnet_state_dict_from_jax({".".join(map(str, p)): np.asarray(v.get_value())
                                          for p, v in state.flat_state()})


def test_forward_matches_jax():
    net, params = _filled_jax_segresnet(0)
    x = np.random.RandomState(2).rand(2, 1, 32, 24, 16).astype(np.float32)
    ref = np.asarray(jax.jit(lambda m, a: m(a))(net, jnp.asarray(x)))
    port = SegResNet(**ARGS, device="cpu").eval()
    port.load_state_dict(segresnet_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 3, 32, 24, 16)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_step_matches_jax_without_the_kink():
    ref_grads, _, _, port = _step(act=NO_KINK)
    ref = _as_port(ref_grads)
    assert set(ref) == {k for k, _ in port.named_parameters()}
    for k, p in port.named_parameters():
        err, scale = (p.grad - ref[k]).abs().max().item(), ref[k].abs().max().item()
        assert err <= 1e-3 * scale, (k, err, scale)


def test_step_and_adamw_update_follow_jax():
    ref_grads, param_state, params, port = _step()
    ref = _as_port(ref_grads)
    for k, p in port.named_parameters():
        cos = torch.nn.functional.cosine_similarity(p.grad.reshape(1, -1).double(), ref[k].reshape(1, -1).double())
        assert cos.item() >= 0.9999, (k, cos.item())
    tx = optax.adamw(LR, weight_decay=WEIGHT_DECAY)
    after = _as_port(jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(ref_grads,
                                                                                                  param_state))
    before = segresnet_state_dict_from_jax(params)
    torch.optim.AdamW(port.parameters(), lr=LR, weight_decay=WEIGHT_DECAY).step()
    for k, p in port.named_parameters():
        moved = ref[k].abs() >= max(0.05 * ref[k].abs().max().item(), 100 * 1e-8)
        err = (p.detach() - after[k]).abs()
        assert err[moved].max().item() <= 1e-6, k
        assert err.max().item() <= 2 * LR + 1e-6, k
        assert not torch.equal(p.detach(), before[k]), k


@pytest.mark.parametrize("channels,groups", [(16, 8), (12, 6), (20, 5), (9, 3), (7, 7)])
def test_group_norm_clamps_the_groups_as_jax(channels, groups):
    port = Norm["group", 3](num_features=channels, num_groups=8)
    ref = JaxNorm["group", 3](channels, num_groups=8, rngs=nnx.Rngs(0))
    assert port.num_groups == ref.num_groups == groups
    assert Norm["group", 3](num_channels=channels).num_groups == groups  # torch's name for the channels
    rng = np.random.RandomState(channels)
    scale, bias = rng.uniform(0.5, 1.5, channels).astype(np.float32), rng.randn(channels).astype(np.float32)
    ref.scale.set_value(jnp.asarray(scale))
    ref.bias.set_value(jnp.asarray(bias))
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    x = (rng.randn(2, channels, 5, 6, 7) * 2 + 1).astype(np.float32)
    want = np.moveaxis(np.asarray(ref(jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_dropout_drops_elements_not_channels():
    net = SegResNet(**ARGS, dropout_prob=0.5, device="cpu")
    assert type(net.dropout) is torch.nn.Dropout
    x = torch.ones(1, 8, 6, 6, 6)
    torch.manual_seed(0)
    dropped = net.train().dropout(x)
    kept = (dropped != 0).float().mean((2, 3, 4))  # the share kept in each channel
    assert ((kept > 0) & (kept < 1)).all()  # no channel dropped or kept whole
    assert torch.equal(net.eval().dropout(x), x)
    assert SegResNet(**ARGS, device="cpu").dropout is None


@pytest.mark.parametrize("mode", ["nearest", "linear"])
def test_upsample_at_an_odd_size_matches_jax(mode):
    x = np.random.RandomState(3).rand(2, 4, 5, 7, 3).astype(np.float32)
    ref = JaxUpSample(3, 4, 4, 2, mode="nontrainable", interp_mode=mode, pre_conv=None, rngs=nnx.Rngs(0))
    want = np.moveaxis(np.asarray(ref(jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    up = (UpSample(3, 4, 4, 2, mode="nontrainable", interp_mode=mode, pre_conv=None) if mode == "nearest"
          else get_upsample_layer(3, 4))
    got = up(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 10, 14, 6)
    if mode == "nearest":
        assert np.array_equal(got, want)
        assert np.array_equal(got, x.repeat(2, 2).repeat(2, 3).repeat(2, 4))  # source index i // 2
    else:
        assert np.abs(got - want).max() <= 1e-6


def test_upsample_modes_not_ported_raise():
    """deconv and pixelshuffle are ported (tests/test_torch_upsample_modes.py holds them to
    JAX); a mode the JAX ``UpSample`` does not know raises, as there."""
    for mode in ("deconv", "pixelshuffle"):
        assert UpSample(3, 4, 4, 2, mode=mode)(torch.zeros(1, 4, 2, 3, 2)).shape == (1, 4, 4, 6, 4)
    with pytest.raises(NotImplementedError):
        UpSample(3, 4, 4, 2, mode="transpose")
