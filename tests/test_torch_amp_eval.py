"""The port's mixed precision against the JAX package's, on the CPU.

``SupervisedEvaluator(amp=True)`` casts only the input to bfloat16, in both packages.
Each layer then runs in the type its rule gives a bfloat16 input and float32 weights: the
JAX package's default 3x3x3 stride-1 conv casts its kernel to the input's type where
min(CI, 128) >= 2 min(CO, 128) and runs in bfloat16, and every other conv promotes to
float32 (``nnx.Conv``). On the Spleen UNet the first conv is a strided one, so after it
every layer runs in float32: the amp evaluation is the float32 evaluation of the input
rounded to bfloat16. Held here:

- the conv rule site by site: a 3x3x3 stride-1 conv of a bfloat16 input against the JAX
  ``Conv`` factory's, the output's type equal and its values within 1e-2 of max|ref|
  where it runs in bfloat16 (one rounding of each operand and of the output) and within
  1e-5 where it runs in float32;
- the amp evaluator on a batch-norm ``UNet(3, 1, 2, (16, 32), (2,), num_res_units=2)`` at
  32^3, both nets with the same numpy-drawn weights and statistics: float32 predictions
  within 1e-4 of max|ref| of the JAX evaluator's (float32 sums in another order), and
  equal bit for bit to the port's float32 evaluation of the rounded input;
- one amp training step (SGD, lr 1) of a batch-norm UNet: the running statistics left as
  they were in both packages, bit for bit (the JAX step updates its bfloat16 view's copies
  only), the loss within 1e-2 relative, and the step (the grads of every parameter, as
  one vector) within 0.1 of its norm (0.053 when written). A tensor at a time bfloat16 is
  too wide to hold: each package's amp grads lie up to 0.4-0.7 of a tensor's max off its
  own float32 grads at this size, while the two packages' float32 grads agree within 4e-5.
  The conv biases that a batch norm follows have an exact grad of 0 and are left out
  (their step is rounding).
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from monai_tpu.engines import SupervisedEvaluator as JaxEvaluator
from monai_tpu.engines import SupervisedTrainer as JaxTrainer
from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
from monai_tpu.networks.layers.factories import Conv as JaxConv
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu_torch.engines import SupervisedEvaluator, SupervisedTrainer
from monai_tpu_torch.losses import DiceCELoss
from monai_tpu_torch.networks.blocks.convolutions import Convolution
from monai_tpu_torch.networks.layers.factories import Conv, kernel_takes_input_type
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax


def _jax_unet(args, seed=7):
    """The JAX batch-norm UNet, built abstractly, its parameters and running statistics
    drawn with numpy; returns it and {path: array}."""
    net = nnx.eval_shape(lambda: JaxUNet(*args, num_res_units=2, norm="batch", rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(seed)
    variables = {}
    for path, var in nnx.state(net).flat_state():
        kind, shape = type(var).__name__, var.get_value().shape
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
        elif kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
        else:
            lo, hi = {"mean": (-0.3, 0.3), "var": (0.2, 2.0), "scale": (0.5, 1.5)}.get(path[-1], (-0.5, 0.5))
            value = rng.uniform(lo, hi, shape).astype(np.float32)
            var.set_value(jnp.asarray(value))
            variables[".".join(map(str, path))] = value
    return net, variables


@pytest.mark.parametrize("ci,co", [(32, 16), (16, 16), (256, 128)])
def test_conv_rule_site_by_site(ci, co):
    rng = np.random.RandomState(ci + co)
    x = rng.randn(1, ci, 6, 6, 6).astype(np.float32)
    w = (rng.randn(co, ci, 3, 3, 3) / np.sqrt(27 * ci)).astype(np.float32)
    b = rng.randn(co).astype(np.float32) * 0.1
    ref = nnx.eval_shape(lambda: JaxConv["conv", 3](ci, co, kernel_size=3, strides=1, rngs=nnx.Rngs(0)))
    ref.kernel.set_value(jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0))))
    ref.bias.set_value(jnp.asarray(b))
    y_ref = jax.jit(lambda m, v: m(v))(ref, jnp.asarray(np.moveaxis(x, 1, -1), jnp.bfloat16))
    conv = Conv["conv", 3](ci, co, kernel_size=3, padding=1, device="cpu")
    conv.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        y = conv(torch.from_numpy(x).to(torch.bfloat16))
    casts = kernel_takes_input_type(ci, co)
    assert casts == (min(ci, 128) >= 2 * min(co, 128))
    want_type = torch.bfloat16 if casts else torch.float32
    assert y.dtype == want_type and str(y_ref.dtype) == str(want_type).split(".")[1]
    y_ref = np.moveaxis(np.asarray(y_ref.astype(jnp.float32)), -1, 1)
    err = np.abs(y.float().numpy() - y_ref).max() / np.abs(y_ref).max()
    assert err <= (1e-2 if casts else 1e-5), err


def test_amp_evaluator_matches_jax():
    args = (3, 1, 2, (16, 32), (2,))
    net, variables = _jax_unet(args)
    rng = np.random.RandomState(5)
    batch = {"image": rng.rand(1, 1, 32, 32, 32).astype(np.float32),
             "label": (rng.rand(1, 1, 32, 32, 32) > 0.5).astype(np.float32)}
    ref = JaxEvaluator(val_data_loader=[batch], network=net, amp=True, decollate=False)
    ref.run()
    y_ref = np.asarray(ref.state.output["pred"])
    assert y_ref.dtype == np.float32

    port = UNet(*args, num_res_units=2, norm="batch", device="cpu")
    port.load_state_dict(unet_state_dict_from_jax(variables))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ev = SupervisedEvaluator(device="cpu", val_data_loader=[tbatch], network=port, amp=True, decollate=False)
    ev.run()
    y = ev.state.output["pred"]
    assert y.dtype == torch.float32 and tuple(y.shape) == y_ref.shape
    assert np.abs(y.numpy() - y_ref).max() <= 1e-4 * np.abs(y_ref).max()
    with torch.no_grad():
        y32 = port.eval()(tbatch["image"].to(torch.bfloat16).float())
    assert torch.equal(y, y32)


def test_amp_train_step_leaves_running_statistics_as_jax():
    args = (3, 1, 2, (4, 8, 16), (2, 2))
    net, variables = _jax_unet(args, seed=11)
    stats0 = {".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.state(net, nnx.BatchStat).flat_state()}
    rng = np.random.RandomState(3)
    batch = {"image": rng.rand(2, 1, 16, 16, 16).astype(np.float32),
             "label": (rng.rand(2, 1, 16, 16, 16) > 0.5).astype(np.float32)}
    ref = JaxTrainer(max_epochs=1, train_data_loader=[batch], network=net, optimizer=optax.sgd(1.0),
                     loss_function=JaxDiceCELoss(to_onehot_y=True, softmax=True), decollate=False, amp=True)
    ref.run()
    loss_ref = float(ref.state.output["loss"])
    after = {".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.state(net).flat_state()
             if type(v).__name__ in ("Param", "BatchStat")}
    for k, v in stats0.items():
        assert np.array_equal(after[k], v), k  # the JAX amp step leaves the model's statistics
    start = unet_state_dict_from_jax(variables)
    moved = unet_state_dict_from_jax(after)

    port = UNet(*args, num_res_units=2, norm="batch", device="cpu")
    port.load_state_dict(start)
    trainer = SupervisedTrainer(device="cpu", max_epochs=1,
                                train_data_loader=[{k: torch.from_numpy(v) for k, v in batch.items()}],
                                network=port, optimizer=torch.optim.SGD(port.parameters(), lr=1.0),
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True), amp=True)
    trainer.run()
    loss = float(trainer.state.output["loss"])
    assert abs(loss - loss_ref) <= 1e-2 * abs(loss_ref)
    got = port.state_dict()
    stats = [k for k in start if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert len(stats) == 3 * sum(isinstance(m, torch.nn.BatchNorm3d) for m in port.modules()) > 0
    for k in stats:
        assert torch.equal(got[k], start[k]), k
    normed = {f"{n}.conv.bias" for n, m in port.named_modules()
              if isinstance(m, Convolution) and "adn" in m._modules and "N" in m.adn._modules}
    assert normed
    step_ref = np.concatenate([(moved[n] - start[n]).numpy().ravel() for n, _ in port.named_parameters()
                               if n not in normed])
    step = np.concatenate([(got[n] - start[n]).numpy().ravel() for n, _ in port.named_parameters() if n not in normed])
    rel = np.linalg.norm(step - step_ref) / np.linalg.norm(step_ref)
    assert rel <= 0.1, rel
