"""A float32 SwinUNETR training step of monai_tpu_torch against monai_tpu's, on the CPU.

One step of a ``SwinUNETR(1, 4, feature_size=12)`` at 32^3 with
``DiceCELoss(to_onehot_y=True, softmax=True)`` in both packages: the JAX net built
abstractly and filled from a numpy seed, its weights carried into the port by
``swin_state_dict_from_jax``, its loss and grads from ``jax.value_and_grad`` (jitted). On
the CPU the JAX net takes its XLA attention (the Pallas kernel is for TPUs), whose grad
is the same function's as the custom VJP's; the port's runs the plain backward of the
attention, the conv and the norm.

- With every LeakyReLU slope at 1 (no kink; every backward still runs) the loss agrees
  to 1e-5 relative and every grad to 1e-4 of its max|ref| (float32 sums in another
  order through ~40 layers, forward and back).
- With the net as it is (slope 0.01) the grads differ by far more than the port's own
  change under a 1e-7 relative change of the input (PR 11's kink rule does not hold);
  the cause is not established (PERF.md §7). They are held to a cosine of at least
  0.9999 each, and the loss to 1e-5.
- Grads that are exactly 0 (the 1x1 residual conv from one input channel, which an
  instance norm follows, and what lies before the norms over the single voxel of the 1^3
  bottleneck) are rounding in both packages; each is held under 1e-3 of the largest grad
  of the net.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

import monai_tpu.networks.blocks.dynunet_block as jax_dynunet
import monai_tpu_torch.networks.blocks.dynunet_block as dynunet
from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
from monai_tpu.networks.nets import swin_unetr as jax_swin
from monai_tpu_torch.losses import DiceCELoss
from monai_tpu_torch.networks.nets import SwinUNETR
from monai_tpu_torch.networks.weights import swin_state_dict_from_jax

# grads that are exactly 0: a 1x1 conv from one channel before an instance norm (the norm
# undoes its scale), and what lies before an instance norm over the one voxel of the 1^3
# bottleneck (its output is its bias, whatever its input)
EXACT_ZERO = {"encoder1.layer.conv3.conv.weight", "encoder10.layer.conv1.conv.weight",
              "encoder10.layer.conv2.conv.weight", "encoder10.layer.norm1.weight", "encoder10.layer.norm1.bias",
              "encoder10.layer.norm2.weight"}


def _filled_jax_swin(seed: int):
    """A JAX SwinUNETR(1, 4, feature_size=12), built abstractly, every variable drawn with
    numpy (biases and norm scales too); returns the module and {path: array}."""
    net = nnx.eval_shape(lambda: jax_swin.SwinUNETR(1, 4, feature_size=12, rngs=nnx.Rngs(0)))
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
        if leaf == "relative_position_index":
            owner = net
            for t in path[:-1]:
                owner = owner[int(t)] if str(t).isdigit() else getattr(owner, t)
            a = jax_swin._rel_pos_index(owner.window_size).astype(np.int32)
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
    return net, params


def _slopes(monkeypatch, slope: float) -> None:
    """Every UNETR block of both packages made with LeakyReLU slope ``slope``."""
    for mod in (jax_dynunet, dynunet):
        for cls in (mod.UnetResBlock, mod.UnetBasicBlock):
            defaults = tuple(("leakyrelu", {"negative_slope": slope})
                             if isinstance(v, tuple) and v and v[0] == "leakyrelu" else v
                             for v in cls.__init__.__defaults__)
            monkeypatch.setattr(cls.__init__, "__defaults__", defaults)


def _step(monkeypatch, slope: float):
    """(loss, grads) of one step in each package: the JAX reference first."""
    _slopes(monkeypatch, slope)
    net, params = _filled_jax_swin(0)
    rng = np.random.RandomState(1)
    x = rng.rand(1, 1, 32, 32, 32).astype(np.float32)
    y = rng.randint(0, 4, (1, 1, 32, 32, 32)).astype(np.float32)
    jax_loss = JaxDiceCELoss(to_onehot_y=True, softmax=True)
    graphdef, state = nnx.split(net)
    param_state, rest = state.split(nnx.Param, ...)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p, a, b: jax_loss(nnx.merge(graphdef, p, rest)(a), b)))(
        param_state, jnp.asarray(x), jnp.asarray(y))
    ref = swin_state_dict_from_jax({".".join(map(str, p)): np.asarray(v.get_value())
                                    for p, v in ref_grads.flat_state()})
    port = SwinUNETR(1, 4, feature_size=12, device="cpu", use_checkpoint=True)
    port.load_state_dict(swin_state_dict_from_jax(params), strict=False)  # the slope buffers are the port's
    assert {b.item() for n, b in port.named_buffers() if n.endswith("lrelu_slope")} == {np.float32(slope)}
    loss = DiceCELoss(to_onehot_y=True, softmax=True)(port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == {k for k in ref if not k.endswith("relative_position_index")}
    largest = max(r.abs().max().item() for r in ref.values() if r.is_floating_point())
    for k in EXACT_ZERO:
        assert grads[k].abs().max().item() <= 1e-3 * largest and ref[k].abs().max().item() <= 1e-3 * largest, k
    return {k: g for k, g in grads.items() if k not in EXACT_ZERO}, ref


def test_swin_training_step_matches_jax_without_the_kink(monkeypatch):
    grads, ref = _step(monkeypatch, 1.0)
    for k, g in grads.items():
        err, scale = (g - ref[k]).abs().max().item(), ref[k].abs().max().item()
        assert err <= 1e-4 * scale, (k, err, scale)


def test_swin_training_step_follows_jax(monkeypatch):
    grads, ref = _step(monkeypatch, 0.01)
    for k, g in grads.items():
        cos = torch.nn.functional.cosine_similarity(g.reshape(1, -1).double(), ref[k].reshape(1, -1).double()).item()
        assert cos >= 0.9999, (k, cos)
