"""The port's batch norm against the JAX package's ``nnx.BatchNorm``, on the CPU.

In train mode torch's ``nn.BatchNorm3d`` adds the unbiased batch variance, n/(n−1) times
the biased one, to ``running_var``; ``nnx.BatchNorm`` adds the biased one. The port's
``Norm["batch"]`` adds the biased one, as the JAX package does, and keeps torch's
normalisation, momentum, eps and state names. Held here:

- one norm on a (2, 4, 3, 3, 3) input (and a 2-D one), against ``nnx.BatchNorm`` and
  against torch's own, which differs from it by n/(n−1) in what it adds;
- a small batch-norm ``UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2)`` in both
  packages, the JAX net's parameters and running statistics carried into the port by
  ``unet_state_dict_from_jax``, after one ``SupervisedTrainer`` iteration (SGD) on a batch
  of 2 16^3 patches: every batch norm's running mean and variance within 1e-6 of its
  max|ref|, and the eval output after the step within 1e-4 of its max|ref| (float32 sums
  in another order, in the step's grads too).
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from monai_tpu.engines import SupervisedTrainer as JaxTrainer
from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu_torch.engines import SupervisedTrainer
from monai_tpu_torch.losses import DiceCELoss
from monai_tpu_torch.networks.layers.factories import Norm
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax

ARGS = (3, 1, 2, (4, 8, 16), (2, 2))
LR = 1e-2
MOMENTUM = 0.1  # torch's; nnx's 0.9 keeps the same share of the old statistics


@pytest.mark.parametrize("shape", [(2, 4, 3, 3, 3), (2, 4, 5, 5)])
def test_batch_norm_adds_the_biased_variance(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * 1.5 + 0.3
    dim = len(shape) - 2
    port = Norm[Norm.BATCH, dim](shape[1], device="cpu").train()
    torch_own = getattr(torch.nn, f"BatchNorm{dim}d")(shape[1]).train()
    ref = nnx.BatchNorm(shape[1], epsilon=1e-5, momentum=1 - MOMENTUM, rngs=nnx.Rngs(0))
    y = port(torch.from_numpy(x))
    y_ref = np.moveaxis(np.asarray(ref(jnp.asarray(np.moveaxis(x, 1, -1)))), -1, 1)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=1e-5 * np.abs(y_ref).max())
    torch_own(torch.from_numpy(x))
    mean, var = np.asarray(ref.mean.get_value()), np.asarray(ref.var.get_value())
    for got, want in ((port.running_mean, mean), (port.running_var, var)):
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # torch's own adds n/(n-1) times the biased variance; its running mean is the port's
    n = x.size // shape[1]
    added, added_own = port.running_var - (1 - MOMENTUM), torch_own.running_var - (1 - MOMENTUM)
    torch.testing.assert_close(added_own / added, torch.full_like(added, n / (n - 1)), rtol=1e-5, atol=0)
    torch.testing.assert_close(torch_own.running_mean, port.running_mean, rtol=0, atol=1e-7)
    assert int(port.num_batches_tracked) == 1
    assert set(port.state_dict()) == set(torch_own.state_dict())
    # eval mode normalises by the running statistics, as torch's does with the same ones
    torch_own.load_state_dict(port.state_dict())
    port.eval(), torch_own.eval()
    assert torch.equal(port(torch.from_numpy(x)), torch_own(torch.from_numpy(x)))


def _jax_unet():
    """The JAX batch-norm UNet, built abstractly, every parameter and running statistic
    drawn with numpy (means away from 0, variances away from 1); returns it and
    {path: array}."""
    net = nnx.eval_shape(lambda: JaxUNet(*ARGS, num_res_units=2, norm="batch", rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(7)
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


def test_unet_train_step_running_statistics_match_jax():
    net, variables = _jax_unet()
    rng = np.random.RandomState(3)
    batch = {"image": rng.rand(2, 1, 16, 16, 16).astype(np.float32),
             "label": (rng.rand(2, 1, 16, 16, 16) > 0.5).astype(np.float32)}
    JaxTrainer(max_epochs=1, train_data_loader=[batch], network=net, optimizer=optax.sgd(LR),
               loss_function=JaxDiceCELoss(to_onehot_y=True, softmax=True), decollate=False).run()
    ref = {".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.state(net, nnx.BatchStat).flat_state()}
    ref = unet_state_dict_from_jax({**variables, **ref})
    net.eval()
    x = np.random.RandomState(4).rand(2, 1, 16, 16, 16).astype(np.float32)
    y_ref = np.asarray(jax.jit(lambda m, v: m(v))(net, jnp.asarray(x)))

    port = UNet(*ARGS, num_res_units=2, norm="batch", device="cpu")
    port.load_state_dict(unet_state_dict_from_jax(variables))
    trainer = SupervisedTrainer(device="cpu", max_epochs=1,
                                train_data_loader=[{k: torch.from_numpy(v) for k, v in batch.items()}],
                                network=port, optimizer=torch.optim.SGD(port.parameters(), lr=LR),
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True))
    trainer.run()
    got = port.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 9
    for k in stats:
        want = ref[k]
        assert not torch.equal(got[k], unet_state_dict_from_jax(variables)[k]), k  # the step moved it
        assert (got[k] - want).abs().max().item() <= 1e-6 * want.abs().max().item(), k
    assert all(int(got[k]) == 1 for k in got if k.endswith("num_batches_tracked"))
    with torch.no_grad():
        y = port.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-4 * np.abs(y_ref).max()
