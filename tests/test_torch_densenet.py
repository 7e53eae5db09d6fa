"""The MedNIST bundle's network, loss and metric in monai_tpu_torch against monai_tpu's, on the CPU.

- ``densenet_state_dict_from_jax`` carries a narrow JAX ``DenseNet(2, 1, 6,
  init_features=8, growth_rate=4, block_config=(2, 2))`` (every parameter and running
  statistic drawn with numpy) into the port's net with ``strict=True``; the forward on a
  batch of 4 64x64 images in eval mode (running statistics) within 1e-5 of the logits' std
  (float32 sums in another order over ~12 layers) and in train mode (batch statistics)
  within 5e-5 (``nnx.BatchNorm`` takes the batch variance as E[x^2] - E[x]^2, torch about
  the mean), and ``forward_features`` likewise.
- One ``SupervisedTrainer`` iteration of the bundle's step, ``CrossEntropyLoss`` and Adam at
  lr 1e-5 (``optax.adam`` and ``torch.optim.Adam``), on a batch of 8 32x32 images with
  integer labels: the loss within 1e-5 relative; the running statistics within 1e-5 of
  their max|ref|; every parameter within two float32 steps of its value (plus 1e-8) where
  the JAX step moved it by at least 0.9 lr (Adam's first step moves it by lr times its
  grad's sign), within 2 lr elsewhere.
- ``DenseNet121(2, 1, 6)``'s parameter names and count against torch MONAI's layout: the
  names built from its rules (``features.denseblock{i}.denselayer{j}.layers.{norm1, conv1,
  norm2, conv2}``, ``features.transition{i}.{norm, conv}``, ``features.norm5``,
  ``class_layers.out``) and 6,953,734 parameters (torchvision's DenseNet-121, 7,978,856,
  with one input channel and six classes); 169, 201 and 264 by their block counts.
- ``CrossEntropyLoss`` on integer, (B, 1) and one-hot targets, with class weights, label
  smoothing, both, and each reduction, against the JAX package's (1e-6 relative); where
  smoothing and weights meet it follows that math, not ``F.cross_entropy``'s.
- ``compute_roc_auc`` and ``ROCAUCMetric`` (ties, each average, a class absent from the
  labels: NaN, which the macro average carries) and the ``ROCAUC`` handler, against the
  JAX package's, exactly (float64 on the host in both), and an engine's aggregation of it
  kept in float64.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from monai_tpu.engines import SupervisedTrainer as JaxTrainer
from monai_tpu.handlers import ROCAUC as JaxROCAUCHandler
from monai_tpu.losses.other import CrossEntropyLoss as JaxCE
from monai_tpu.metrics.regression import ROCAUCMetric as JaxROCAUCMetric
from monai_tpu.metrics.regression import compute_roc_auc as jax_roc_auc
from monai_tpu.networks.nets.densenet import DenseNet as JaxDenseNet
from monai_tpu_torch.engines import SupervisedTrainer
from monai_tpu_torch.handlers import ROCAUC
from monai_tpu_torch.losses import CrossEntropyLoss
from monai_tpu_torch.metrics import ROCAUCMetric, compute_roc_auc
from monai_tpu_torch.networks import densenet_state_dict_from_jax
from monai_tpu_torch.networks.nets import DenseNet, DenseNet121, DenseNet169, DenseNet201, DenseNet264

NARROW = dict(init_features=8, growth_rate=4, block_config=(2, 2))
LR = 1e-5


def _jax_net(seed: int = 11):
    """The narrow JAX DenseNet, every parameter and running statistic drawn with numpy;
    returns it and {path: array}."""
    net = JaxDenseNet(2, 1, 6, **NARROW, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(seed)
    variables = {}
    for path, var in nnx.state(net).flat_state():
        kind, shape = type(var).__name__, var.get_value().shape
        if kind not in ("Param", "BatchStat"):
            continue
        lo, hi = {"mean": (-0.3, 0.3), "var": (0.2, 2.0), "scale": (0.5, 1.5)}.get(path[-1], (-0.5, 0.5))
        value = rng.uniform(lo, hi, shape).astype(np.float32)
        var.set_value(jnp.asarray(value))
        variables[".".join(map(str, path))] = value
    return net, variables


def _port(variables) -> DenseNet:
    net = DenseNet(2, 1, 6, **NARROW, device="cpu")
    net.load_state_dict(densenet_state_dict_from_jax(variables), strict=True)
    return net


@pytest.mark.parametrize("train", [False, True])
def test_narrow_densenet_forward_matches_jax(train):
    ref_net, variables = _jax_net()
    net = _port(variables)
    x = np.random.RandomState(1).rand(4, 1, 64, 64).astype(np.float32)
    ref_net.train() if train else ref_net.eval()
    net.train(train)
    ref = np.asarray(ref_net(jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        feats = net.forward_features(torch.from_numpy(x)).numpy()
    # train mode: nnx.BatchNorm takes the batch variance as E[x^2] - E[x]^2, torch about the mean
    tol = 5e-5 if train else 1e-5
    assert got.shape == ref.shape == (4, 6)
    assert np.abs(got - ref).max() <= tol * ref.std()
    ref_feats = np.asarray(ref_net.forward_features(jnp.asarray(x)))
    assert feats.shape == ref_feats.shape == (4, 16, 8, 8)
    assert np.abs(feats - ref_feats).max() <= tol * ref_feats.std()


def test_densenet_adam_step_matches_jax():
    ref_net, variables = _jax_net(12)
    rng = np.random.RandomState(13)
    batch = {"image": rng.rand(8, 1, 32, 32).astype(np.float32), "label": rng.randint(0, 6, 8).astype(np.int64)}
    jax_trainer = JaxTrainer(max_epochs=1, train_data_loader=[batch], network=ref_net, optimizer=optax.adam(LR),
                             loss_function=JaxCE(), decollate=False)
    jax_trainer.run()
    ref_loss = float(np.asarray(jax_trainer.state.output["loss"]))
    after = {".".join(map(str, p)): np.asarray(v.get_value())
             for kind in (nnx.Param, nnx.BatchStat) for p, v in nnx.state(ref_net, kind).flat_state()}
    ref, before = densenet_state_dict_from_jax(after), densenet_state_dict_from_jax(variables)

    net = _port(variables)
    trainer = SupervisedTrainer(device="cpu", max_epochs=1,
                                train_data_loader=[{k: torch.from_numpy(v) for k, v in batch.items()}],
                                network=net, optimizer=lambda p: torch.optim.Adam(p, lr=LR),
                                loss_function=CrossEntropyLoss())
    trainer.run()
    loss = trainer.state.output["loss"].item()
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    got = net.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 11  # norm0, two norms in each of two layers of two blocks, the transition, norm5
    for k in stats:
        assert not torch.equal(got[k], before[k]), k
        assert (got[k] - ref[k]).abs().max().item() <= 1e-5 * ref[k].abs().max().item(), k
    for k, p in net.named_parameters():
        err = (p.detach() - ref[k]).abs()
        assert err.max().item() <= 2 * LR, k
        moved = (ref[k] - before[k]).abs() >= 0.9 * LR
        ulps = 2 * torch.finfo(torch.float32).eps * ref[k].abs() + 1e-8  # p - lr·sign rounded in float32
        assert moved.any() and (err[moved] <= ulps[moved]).all(), k


def _torch_monai_names(block_config) -> set:
    """DenseNet's parameter names by torch MONAI's layout."""
    norm = ("weight", "bias")
    names = {"features.conv0.weight", "class_layers.out.weight", "class_layers.out.bias"}
    names |= {f"features.norm0.{p}" for p in norm} | {f"features.norm5.{p}" for p in norm}
    for i, layers in enumerate(block_config, 1):
        for j in range(1, layers + 1):
            pre = f"features.denseblock{i}.denselayer{j}.layers"
            names |= {f"{pre}.conv1.weight", f"{pre}.conv2.weight"}
            names |= {f"{pre}.{n}.{p}" for n in ("norm1", "norm2") for p in norm}
        if i < len(block_config):
            names |= {f"features.transition{i}.conv.weight"} | {f"features.transition{i}.norm.{p}" for p in norm}
    return names


def test_densenet121_has_torch_monai_names_and_size():
    net = DenseNet121(2, 1, 6, device="cpu")
    params = dict(net.named_parameters())
    assert set(params) == _torch_monai_names((6, 12, 24, 16))
    assert sum(p.numel() for p in params.values()) == 6953734
    assert net.class_layers.out.in_features == 1024
    assert all(k.replace("running_mean", "weight") in params for k in net.state_dict() if "running_mean" in k)
    with torch.no_grad():
        assert net.eval()(torch.zeros(2, 1, 64, 64)).shape == (2, 6)
    for make, blocks in ((DenseNet169, (6, 12, 32, 32)), (DenseNet201, (6, 12, 48, 32)),
                         (DenseNet264, (6, 12, 64, 48))):
        assert {k for k, _ in make(2, 1, 3, device="cpu").named_parameters()} == _torch_monai_names(blocks)


@pytest.mark.parametrize("kwargs", [dict(), dict(weight=[1.0, 2.0, 0.5, 1.0, 3.0, 1.0]), dict(label_smoothing=0.1),
                                    dict(weight=[1.0, 2.0, 0.5, 1.0, 3.0, 1.0], label_smoothing=0.2),
                                    dict(reduction="sum"), dict(reduction="none", weight=[1.0, 2.0, 0.5, 1.0, 3.0, 1.0])])
def test_cross_entropy_matches_jax(kwargs):
    rng = np.random.RandomState(4)
    logits = rng.randn(8, 6).astype(np.float32) * 2
    labels = rng.randint(0, 6, 8)
    loss, ref_loss = CrossEntropyLoss(**kwargs), JaxCE(**kwargs)
    for target in (labels, labels[:, None], np.eye(6, dtype=np.float32)[labels]):
        ref = np.asarray(ref_loss(jnp.asarray(logits), jnp.asarray(target)))
        got = loss(torch.from_numpy(logits), torch.from_numpy(target)).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    if "weight" in kwargs and "label_smoothing" in kwargs:  # where torch's own call differs
        torch_ce = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   weight=torch.tensor(kwargs["weight"]), label_smoothing=kwargs["label_smoothing"])
        assert abs(torch_ce.item() - float(ref)) > 1e-3


def test_roc_auc_matches_jax():
    rng = np.random.RandomState(5)
    pred = rng.rand(12, 6)
    pred[1, 0] = pred[0, 0]  # a tie
    pred[:4, 3] = 0.5
    labels = np.eye(6)[np.arange(12) % 6]
    absent = np.eye(6)[np.arange(12) % 4]  # classes 4 and 5 absent: their AUC is NaN
    for y in (labels, absent):
        for average in ("macro", "weighted", "micro", "none"):
            ref = jax_roc_auc(pred, y, average)
            got = compute_roc_auc(torch.from_numpy(pred), torch.from_numpy(y), average)
            np.testing.assert_array_equal(np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64))
    assert np.isnan(compute_roc_auc(pred, absent)) and np.isfinite(compute_roc_auc(pred, labels))
    assert compute_roc_auc(pred[:, 0], labels[:, 0]) == jax_roc_auc(pred[:, 0], labels[:, 0])
    metric, ref_metric = ROCAUCMetric(), JaxROCAUCMetric()
    handler, ref_handler = ROCAUC(), JaxROCAUCHandler()
    for sl in (slice(0, 5), slice(5, 12)):
        metric(torch.from_numpy(pred[sl]), torch.from_numpy(labels[sl]))
        ref_metric(pred[sl], labels[sl])
        handler(torch.from_numpy(pred[sl]), torch.from_numpy(labels[sl]))
        ref_handler(pred[sl], labels[sl])
    assert metric.aggregate() == ref_metric.aggregate() == handler.aggregate() == ref_handler.aggregate()
    # an engine keeps the float64 value (fault C11: it was rounded to float32)
    from monai_tpu_torch.engines import Workflow

    engine = Workflow(device="cpu", key_metric={"val_rocauc": handler})
    engine._aggregate_metrics()
    assert engine.state.metrics["val_rocauc"] == ref_metric.aggregate() and engine.state.best_metric_epoch == 0
    assert handler.metric_fn.get_buffer() is None  # aggregated and reset
