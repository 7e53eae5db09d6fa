"""monai_tpu_torch's training step against monai_tpu's, on the CPU, in float32.

A small UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2) in both packages, the JAX
net's parameters carried into the port by ``unet_state_dict_from_jax``, trained for 3
``SupervisedTrainer`` iterations on batches of 2 16^3 patches with
``DiceCELoss(to_onehot_y=True, softmax=True)``: ``optax.adam`` against
``torch.optim.Adam`` and ``optax.adamw(1e-4)`` against ``AdamW(weight_decay=1e-4)``
(optax's default decay; torch's is 1e-2). The loss at each step agrees to 1e-4
relative, and the parameters after the last step to 1e-5 absolute. The conv biases that
an instance norm follows have an exact grad of 0: what each framework computes for them
is rounding (~1e-9), and Adam's first steps move a parameter by about lr times
g / (|g| + eps) whatever the size of g, so their sign, and their step, is noise. They are
held instead to where Adam can take them: each run moves them by at most lr a step, so
the two differ by at most 2 x 3 lr.

The port's conv and norm wrappers under autograd (the JAX custom VJP rules) and the
amp view of the parameters are held here too; the kernels themselves are held to their
plain versions on the card, in tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from monai_tpu.engines import Events as JaxEvents
from monai_tpu.engines import SupervisedTrainer as JaxTrainer
from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu_torch.engines import Events, SupervisedTrainer
from monai_tpu_torch.losses import DiceCELoss
from monai_tpu_torch.networks.blocks.convolutions import Convolution
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.utils import amp_model_view, cast_params_to_compute, one_hot
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax

ARGS = (3, 1, 2, (4, 8, 16), (2, 2))
LR, STEPS = 1e-4, 3


def _jax_params(net) -> dict:
    return {".".join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.state(net, nnx.Param).flat_state()}


def _batches():
    rng = np.random.RandomState(3)
    return [{"image": rng.rand(2, 1, 16, 16, 16).astype(np.float32),
             "label": (rng.rand(2, 1, 16, 16, 16) > 0.5).astype(np.float32)} for _ in range(STEPS)]


def _normed_biases(net) -> set[str]:
    return {f"{name}.conv.bias" for name, m in net.named_modules()
            if isinstance(m, Convolution) and "adn" in m._modules and "N" in m.adn._modules}


@pytest.fixture(scope="module")
def start():
    """The JAX net with random biases and slopes (nnx's zeros and 0.25 would hide a
    mis-mapped one) and its parameters as the port's state dict."""
    net = JaxUNet(*ARGS, num_res_units=2, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(7)
    for path, var in nnx.state(net, nnx.Param).flat_state():
        if path[-1] in ("bias", "alpha"):
            var.set_value(jnp.asarray(rng.uniform(0.05, 0.5, var.get_value().shape).astype(np.float32)))
    return _jax_params(net)


def _jax_run(params: dict, tx) -> tuple[list[float], dict]:
    net = JaxUNet(*ARGS, num_res_units=2, rngs=nnx.Rngs(0))
    for path, var in nnx.state(net, nnx.Param).flat_state():
        var.set_value(jnp.asarray(params[".".join(map(str, path))]))
    losses = []
    trainer = JaxTrainer(max_epochs=1, train_data_loader=_batches(), network=net, optimizer=tx,
                         loss_function=JaxDiceCELoss(to_onehot_y=True, softmax=True), decollate=False)
    trainer.add_event_handler(JaxEvents.ITERATION_COMPLETED, lambda e: losses.append(float(e.state.output["loss"])))
    trainer.run()
    return losses, unet_state_dict_from_jax(_jax_params(net))


def _port_run(params: dict, make_opt) -> tuple[list[float], dict]:
    net = UNet(*ARGS, num_res_units=2, device="cpu")
    net.load_state_dict(unet_state_dict_from_jax(params))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()]
    losses = []
    trainer = SupervisedTrainer(device="cpu", max_epochs=1, train_data_loader=batches, network=net,
                                optimizer=make_opt(net.parameters()),
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True))
    trainer.add_event_handler(Events.ITERATION_COMPLETED, lambda e: losses.append(e.state.output["loss"].item()))
    trainer.run()
    assert trainer.state.iteration == STEPS and all(p.grad is not None for p in net.parameters())
    return losses, {k: v.detach() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_supervised_trainer_matches_jax(start, optimizer):
    if optimizer == "adam":
        tx, make = optax.adam(LR), lambda p: torch.optim.Adam(p, lr=LR)
    else:
        tx, make = optax.adamw(LR), lambda p: torch.optim.AdamW(p, lr=LR, weight_decay=1e-4)
    ref_losses, ref = _jax_run(start, tx)
    losses, got = _port_run(start, make)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    zero = _normed_biases(UNet(*ARGS, num_res_units=2, device="cpu"))
    assert set(got) == set(ref) and len(zero) == 9
    for k, r in ref.items():
        diff = (got[k] - r).abs().max().item()
        if k in zero:
            assert diff <= 2 * STEPS * LR, (k, diff)
        else:
            assert diff <= 1e-5, (k, diff)


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SupervisedTrainer(train_data_loader=[], network=torch.nn.Linear(1, 1))


def test_amp_step_runs_bfloat16_with_float32_grads():
    """The amp view: every layer computes in bfloat16, the grads land in float32 on the
    masters, and a step agrees with the float32 step's loss to bfloat16's precision."""
    net = UNet(*ARGS, num_res_units=2, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.rand((1, 1, 16, 16, 16), generator=torch.Generator().manual_seed(1))
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o.dtype)) for m in net.modules()
             if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d, Convolution))]
    out = amp_model_view(net)(x.to(torch.bfloat16))
    for h in hooks:
        h.remove()
    assert out.dtype == torch.bfloat16 and len(seen) > 20 and set(seen) == {torch.bfloat16}
    out.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in net.parameters())
    view = cast_params_to_compute({"w": torch.ones(2), "n": torch.ones(2, dtype=torch.long)})
    assert view["w"].dtype == torch.bfloat16 and view["n"].dtype == torch.long


def test_amp_trainer_step_follows_the_float32_step():
    losses = {}
    for amp in (False, True):
        net = UNet(*ARGS, num_res_units=2, device="cpu", generator=torch.Generator().manual_seed(0))
        batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()]
        trainer = SupervisedTrainer(device="cpu", train_data_loader=batches, network=net, amp=amp,
                                    optimizer=torch.optim.AdamW(net.parameters(), lr=LR, weight_decay=1e-4),
                                    loss_function=DiceCELoss(to_onehot_y=True, softmax=True),
                                    optim_set_to_none=True)
        out = []
        trainer.add_event_handler(Events.ITERATION_COMPLETED, lambda e: out.append(e.state.output))
        trainer.run()
        assert all(o["pred"].dtype == torch.float32 for o in out)
        losses[amp] = [o["loss"].item() for o in out]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-2)


def test_one_hot():
    labels = torch.tensor([[[0, 2], [1, 0]]]).unsqueeze(1)  # (1, 1, 2, 2)
    oh = one_hot(labels, 3)
    assert oh.shape == (1, 3, 2, 2) and oh.dtype == torch.float32
    assert torch.equal(oh.argmax(1, keepdim=True), labels)
    assert one_hot(torch.tensor([1, 0]), 2, dim=1).shape == (2, 2)


def test_trainer_feeds_its_key_metric_and_trains_a_batch_norm_unet():
    """A key train metric (DiceMetric on the argmax, by a postprocessing of the output) is
    aggregated at the epoch's end; the batch-norm UNet trains too (its running statistics
    move, and no fused norm is taken)."""
    from monai_tpu_torch.metrics import DiceMetric

    net = UNet(*ARGS, num_res_units=2, norm="batch", device="cpu", generator=torch.Generator().manual_seed(0))
    before = net.model[0].conv.unit0.adn.N.running_mean.clone()
    assert not any(m.fused_norm_prelu for m in net.modules() if isinstance(m, Convolution))

    def post(out):
        return {**out, "pred": one_hot(out["pred"].argmax(1, keepdim=True), 2), "label": one_hot(out["label"], 2)}

    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()]
    trainer = SupervisedTrainer(device="cpu", max_epochs=2, train_data_loader=batches, network=net,
                                optimizer=torch.optim.Adam(net.parameters(), lr=LR),
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True), postprocessing=post,
                                key_train_metric={"train_dice": DiceMetric()})
    trainer.run()
    assert trainer.state.iteration == 2 * STEPS and trainer.state.epoch == 2
    assert 0.0 < trainer.state.metrics["train_dice"] <= 1.0 and trainer.state.best_metric_epoch in (1, 2)
    assert not torch.equal(net.model[0].conv.unit0.adn.N.running_mean, before)
