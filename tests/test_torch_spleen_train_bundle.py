"""The Spleen bundle's train.json in monai_tpu_torch, on the CPU.

- The float32 batch-norm ``UNet(3, 1, 2, (8, 16, 32, 64), (2, 2, 2), num_res_units=2,
  norm="batch")`` (the bundle's net, narrower) in both packages, the JAX net's parameters
  and running statistics carried into the port by ``unet_state_dict_from_jax``, after one
  ``SupervisedTrainer`` iteration with the bundle's ``DiceCELoss(to_onehot_y=True,
  softmax=True)`` and Adam (lr 1e-4: ``optax.adam`` and ``torch.optim.Adam``) on a batch of
  8 16^3 crops (2 images x 4 crops, as the bundle's loader gives): the loss within 1e-5
  relative; every running mean and variance within 1e-5 of its max|ref| (the batch's
  statistics after ~10 layers of float32 sums in another order); every parameter
  within 1e-6 where the JAX step moved it by at least 0.9 lr (Adam's first step moves a
  parameter by lr times its grad's sign wherever the grad is far above eps), and within 2
  lr elsewhere: the conv biases that a batch norm follows, whose exact grad is 0, move by
  whatever their rounding gives.
- The bundle's ``train.json`` through the port's runner, its command line parsed as
  ``python -m monai_tpu_torch.bundle run`` parses it, ``optax.adam`` overridden by
  ``torch.optim.Adam``: 4 synthetic images (the file's own 96^3 phantoms, 64x64x48 after
  its Spacingd), one epoch at roi 32, batch 2 x 4 crops; it trains, validates
  (``val_mean_dice`` finite in [0, 1]) and writes ``models/model_final.ckpt``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import nnx

from monai_tpu.engines import SupervisedTrainer as JaxTrainer
from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu_torch.engines import SupervisedTrainer
from monai_tpu_torch.losses import DiceCELoss
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_JSON = os.path.join(REPO, "bundles", "spleen_ct_segmentation", "configs", "train.json")
ARGS = (3, 1, 2, (8, 16, 32, 64), (2, 2, 2))
LR = 1e-4


def _jax_unet():
    """The JAX batch-norm UNet, built abstractly, every parameter and running statistic
    drawn with numpy; returns it and {path: array}."""
    net = nnx.eval_shape(lambda: JaxUNet(*ARGS, num_res_units=2, norm="batch", rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(11)
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


def test_batch_norm_unet_adam_step_matches_jax():
    net, variables = _jax_unet()
    rng = np.random.RandomState(12)
    batch = {"image": rng.rand(8, 1, 16, 16, 16).astype(np.float32),
             "label": (rng.rand(8, 1, 16, 16, 16) > 0.7).astype(np.float32)}
    ref_losses = []
    jax_trainer = JaxTrainer(max_epochs=1, train_data_loader=[batch], network=net, optimizer=optax.adam(LR),
                             loss_function=JaxDiceCELoss(to_onehot_y=True, softmax=True), decollate=False)
    jax_trainer.run()
    ref_losses.append(float(np.asarray(jax_trainer.state.output["loss"])))
    after = {".".join(map(str, p)): np.asarray(v.get_value())
             for kind in (nnx.Param, nnx.BatchStat) for p, v in nnx.state(net, kind).flat_state()}
    ref, before = unet_state_dict_from_jax(after), unet_state_dict_from_jax(variables)

    port = UNet(*ARGS, num_res_units=2, norm="batch", device="cpu")
    port.load_state_dict(before)
    trainer = SupervisedTrainer(device="cpu", max_epochs=1,
                                train_data_loader=[{k: torch.from_numpy(v) for k, v in batch.items()}],
                                network=port, optimizer=lambda p: torch.optim.Adam(p, lr=LR),
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True))
    trainer.run()
    loss = trainer.state.output["loss"].item()
    assert abs(loss - ref_losses[0]) <= 1e-5 * abs(ref_losses[0])
    got = port.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 13  # the 13 batch norms of four levels
    for k in stats:
        assert not torch.equal(got[k], before[k]), k  # the step moved it
        assert (got[k] - ref[k]).abs().max().item() <= 1e-5 * ref[k].abs().max().item(), k
    params = dict(port.named_parameters())
    assert set(params) == {k for k in ref if k not in stats and not k.endswith("num_batches_tracked")}
    # the conv biases a batch norm follows
    normed = {k for k in params if k.endswith(".conv.bias") and k[:-len("conv.bias")] + "adn.N.weight" in params}
    assert len(normed) == 13
    for k, p in params.items():
        err = (p.detach() - ref[k]).abs()
        assert err.max().item() <= 2 * LR + 1e-6, k
        if k not in normed:  # a normed bias's grad is rounding, which decides its step
            moved = (ref[k] - before[k]).abs() >= 0.9 * LR
            assert moved.any() and err[moved].max().item() <= 1e-6, k


def test_spleen_train_json_through_the_port_runner(tmp_path):
    cfg = json.load(open(TRAIN_JSON))
    imports = [i.replace("monai_tpu.", "monai_tpu_torch.") for i in cfg["imports"]]
    args = ["--bundle_root", str(tmp_path), "--imports", json.dumps(imports),
            "--initialize", json.dumps(["$import monai_tpu_torch",
                                        "$monai_tpu_torch.utils.set_determinism(seed=123)"]),
            "--optimizer", json.dumps({"_target_": "torch.optim.Adam", "_mode_": "partial", "lr": 1e-4}),
            "--num_synth_images", "4", "--epochs", "1", "--roi_size", "[32, 32, 32]",
            "--network::device", "cpu", "--trainer::device", "cpu", "--evaluator::device", "cpu",
            "--preprocessing::transforms::0::device", "cpu", "--val_preprocessing::transforms::0::device", "cpu"]
    from monai_tpu_torch.bundle.__main__ import parse_args
    from monai_tpu_torch.bundle.workflows import ConfigWorkflow

    _, kwargs = parse_args(args)
    wf = ConfigWorkflow(config_file=TRAIN_JSON, workflow_type=None, **kwargs)
    wf.initialize()
    wf.run()
    trainer = wf.parser.get_parsed_content("trainer")
    assert trainer.state.iteration == 2 and isinstance(trainer.optimizer, torch.optim.Adam)
    assert trainer.data_loader.batch_size == 2  # 3 training images: batches of 2 and 1 image, 4 crops each
    assert trainer.state.batch["image"].data.shape == (4, 1, 32, 32, 32)
    dice = wf.parser.get_parsed_content("evaluator").state.metrics["val_mean_dice"]
    assert np.isfinite(dice) and 0.0 <= dice <= 1.0
    net = UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2, norm="batch",
               device="cpu")
    net.load_state_dict(torch.load(tmp_path / "models" / "model_final.ckpt", weights_only=True)["model"])
    trained = wf.parser.get_parsed_content("network")
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(), trained.state_dict().values()))
    assert int(trained.state_dict()["model.0.conv.unit0.adn.N.num_batches_tracked"]) == 2
