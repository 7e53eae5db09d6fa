"""DynUNet and DeepSupervisionLoss of monai_tpu_torch against monai_tpu's, on the CPU.

The JAX net is built abstractly and filled from a numpy seed (the norms' scales and
biases too); ``dynunet_state_dict_from_jax`` carries its parameters into the port. Where
the JAX package's float32 is itself off the math, the port is also held to its own
network run in float64 (torch's conv and instance norm in place of the kernels' float32
wrappers, torch autograd for the grads).

- The forward at 3-4 stages, filters 8-32, 16^3-32^3 inputs: deep supervision on and off,
  basic and residual blocks, anisotropic kernels and strides ((1, 3, 3), (1, 2, 2)): within
  1e-5 of max|ref| of the float64 forward, and within 3e-5 of max|ref| of the JAX forward,
  which computes in float32 and is itself up to 1.25e-5 off the float64 one (with residual
  blocks; so too under ``jax_enable_x64``). With
  deep supervision both return the stack of the output and the heads on axis 1, the
  heads resized by nearest neighbours, in eval mode too.
- One step of ``DeepSupervisionLoss(DiceCELoss(to_onehot_y=True, softmax=True))`` over the
  stacked heads: the loss within 1e-5 relative of JAX's; with every LeakyReLU of slope 1 (no
  kink; every backward still runs) each grad within 1e-4 of its max|ref| of the float64
  grads, and of JAX's wherever JAX's is itself within 1e-4 of them (a head's bias is off
  by 3.3e-4 in the JAX package's float32); with the slope of 0.01 as it is, float32 order
  differences flip branches, so each grad is held by its cosine with the JAX grad, at
  least 0.999.
- ``DeepSupervisionLoss``'s weights in each mode and its target resized to a head's size
  (nearest, at integer and other factors) equal the JAX package's.
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
from monai_tpu.losses.other import DeepSupervisionLoss as JaxDeepSupervisionLoss
from monai_tpu.networks.nets.dynunet import DynUNet as JaxDynUNet
from monai_tpu_torch.losses import DeepSupervisionLoss, DiceCELoss
from monai_tpu_torch.networks.layers import fast_norm
from monai_tpu_torch.networks.layers.factories import Conv3d
from monai_tpu_torch.networks.nets import DynUNet
from monai_tpu_torch.networks.weights import dynunet_state_dict_from_jax

NO_KINK = ("leakyrelu", {"negative_slope": 1.0})
CASES = {
    "basic": dict(kernel_size=[[3, 3, 3]] * 3, strides=[1, 2, 2], filters=[8, 16, 32], shape=(16, 16, 16)),
    "basic_ds_aniso": dict(kernel_size=[[1, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]],
                           strides=[[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2]], filters=[8, 16, 16, 32],
                           deep_supervision=True, deep_supr_num=2, shape=(16, 24, 32)),
    "res_ds": dict(kernel_size=[[3, 3, 3]] * 4, strides=[1, 2, 2, 2], filters=[8, 16, 16, 24], res_block=True,
                   deep_supervision=True, deep_supr_num=1, shape=(16, 16, 16)),
    "res_aniso": dict(kernel_size=[[1, 3, 3], [3, 3, 3], [3, 3, 3]], strides=[[1, 1, 1], [1, 2, 2], [2, 2, 2]],
                      filters=[8, 16, 32], res_block=True, shape=(24, 16, 20)),
}


def _args(case: dict) -> tuple[dict, tuple]:
    kw = {k: v for k, v in case.items() if k != "shape"}
    kw["upsample_kernel_size"] = kw["strides"][1:]
    return dict(spatial_dims=3, in_channels=1, out_channels=2, **kw), case["shape"]


def _filled_jax_dynunet(args: dict, seed: int = 0):
    """A JAX DynUNet built abstractly, every parameter drawn with numpy; returns the module
    and {path: array}."""
    net = nnx.eval_shape(lambda: JaxDynUNet(**args, rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(seed)
    params = {}
    for path, var in nnx.state(net).flat_state():
        shape, leaf = var.get_value().shape, path[-1]
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


@contextlib.contextmanager
def _float64():
    """The port's kernel 1 and B2 wrappers (float32, bfloat16, float16) replaced by torch's
    conv and instance norm, with the slope after it, which take float64."""
    def norm(x, weight=None, bias=None, slope=None, eps=1e-5):
        y = F.instance_norm(x, weight=weight, bias=bias, eps=eps)
        return y if slope is None else torch.where(y >= 0, y, y * slope.reshape(1, -1, *(1,) * (y.ndim - 2)))

    saved = Conv3d.forward, fast_norm.instance_norm_prelu
    Conv3d.forward, fast_norm.instance_norm_prelu = torch.nn.Conv3d.forward, norm
    try:
        yield
    finally:
        Conv3d.forward, fast_norm.instance_norm_prelu = saved


def _port(args: dict, params: dict) -> DynUNet:
    port = DynUNet(**args, device="cpu")
    port.load_state_dict(dynunet_state_dict_from_jax(params), strict=True)
    return port


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    args, shape = _args(CASES[name])
    net, params = _filled_jax_dynunet(args)
    x = np.random.RandomState(2).rand(2, 1, *shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda m, a: m(a))(net, jnp.asarray(x)))
    port = _port(args, params).eval()
    with torch.no_grad(), _float64():
        exact = copy.deepcopy(port).double()(torch.from_numpy(x).double()).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    heads = args.get("deep_supr_num", 0) if args.get("deep_supervision") else None
    assert got.shape == ref.shape == ((2, heads + 1, 2, *shape) if heads else (2, 2, *shape))
    scale = np.abs(ref).max()
    assert np.abs(got - exact).max() <= 1e-5 * scale
    assert np.abs(got - ref).max() <= 3e-5 * scale


def _ds_step(act=None):
    """(JAX loss, JAX grads as the port's names, port loss, port net) of one step of the
    deep-supervision case."""
    args, shape = _args(CASES["basic_ds_aniso"])
    if act is not None:
        args["act_name"] = act
    net, params = _filled_jax_dynunet(args, seed=3)
    rng = np.random.RandomState(4)
    x = rng.rand(1, 1, *shape).astype(np.float32)
    y = (rng.rand(1, 1, *shape) > 0.5).astype(np.float32)
    jax_loss = JaxDeepSupervisionLoss(JaxDiceCELoss(to_onehot_y=True, softmax=True))
    graphdef, state = nnx.split(net)
    param_state, rest = state.split(nnx.Param, ...)

    def loss_of(p, a, b):
        out = nnx.merge(graphdef, p, rest)(a)
        return jax_loss([out[:, i] for i in range(out.shape[1])], b)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_of))(param_state, jnp.asarray(x), jnp.asarray(y))
    port = _port(args, params)
    loss_fn = DeepSupervisionLoss(DiceCELoss(to_onehot_y=True, softmax=True))
    loss = loss_fn(list(torch.unbind(port(torch.from_numpy(x)), 1)), torch.from_numpy(y))
    loss.backward()
    ref = dynunet_state_dict_from_jax({".".join(map(str, p)): np.asarray(v.get_value())
                                       for p, v in ref_grads.flat_state()})
    assert set(ref) == {k for k, _ in port.named_parameters()}
    exact = copy.deepcopy(port).double()
    with _float64():
        loss_fn(list(torch.unbind(exact(torch.from_numpy(x).double()), 1)), torch.from_numpy(y).double()).backward()
    return float(ref_loss), ref, loss.item(), port, {k: p.grad for k, p in exact.named_parameters()}


def test_step_matches_jax_without_the_kink():
    ref_loss, ref, loss, port, exact = _ds_step(NO_KINK)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    held_to_jax = 0
    for k, p in port.named_parameters():
        scale = exact[k].abs().max().item()
        assert (p.grad.double() - exact[k]).abs().max().item() <= 1e-4 * scale, k
        if (ref[k].double() - exact[k]).abs().max().item() <= 1e-4 * scale:
            held_to_jax += 1
            assert (p.grad - ref[k]).abs().max().item() <= 1e-4 * ref[k].abs().max().item(), k
    assert held_to_jax >= len(ref) - 2


def test_step_matches_jax_with_the_leaky_relu():
    ref_loss, ref, loss, port, _ = _ds_step()
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for k, p in port.named_parameters():
        cos = torch.nn.functional.cosine_similarity(p.grad.reshape(1, -1), ref[k].reshape(1, -1)).item()
        assert cos >= 0.999, (k, cos)


@pytest.mark.parametrize("mode", ["same", "exp", "two", "other"])
def test_deep_supervision_weights_match_jax(mode):
    for weights in (None, [0.3, 0.2]):
        ref, got = JaxDeepSupervisionLoss(None, mode, weights), DeepSupervisionLoss(None, mode, weights)
        for levels in range(0, 7):
            assert got.get_weights(levels) == ref.get_weights(levels)


@pytest.mark.parametrize("size", [(8, 6, 5), (4, 3, 7), (16, 12, 10)])
def test_deep_supervision_target_resize_matches_jax(size):
    target = np.random.RandomState(5).randint(0, 3, (2, 1, 16, 12, 10)).astype(np.float32)
    head = np.zeros((2, 3, *size), np.float32)
    ref = JaxDeepSupervisionLoss(lambda i, t: t).get_loss(jnp.asarray(head), jnp.asarray(target))
    got = DeepSupervisionLoss(lambda i, t: t).get_loss(torch.from_numpy(head), torch.from_numpy(target))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the weighted sum over heads of a loss, in float32
    rng = np.random.RandomState(6)
    heads = [rng.rand(2, 3, *s).astype(np.float32) for s in ((16, 12, 10), size)]

    def jax_mean(i, t):
        return jnp.mean(i) + jnp.mean(t)

    def torch_mean(i, t):
        return i.mean() + t.mean()

    ref = JaxDeepSupervisionLoss(jax_mean)([jnp.asarray(h) for h in heads], jnp.asarray(target))
    got = DeepSupervisionLoss(torch_mean)([torch.from_numpy(h) for h in heads], torch.from_numpy(target))
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))
