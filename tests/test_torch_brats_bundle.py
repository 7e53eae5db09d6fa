"""The BraTS training bundle in monai_tpu_torch, on the CPU.

- The bundle's preprocessing (``bundles/brats_segresnet/configs/train.json`` at
  ``roi_size`` 32) on one synthetic 64^3 phantom with BraTS labels, in both packages with
  the same seed: the same crops of the same voxels (the image within 1e-5 of max|ref|:
  ``NormalizeIntensityd`` sums its statistics in float64 in the port, float32 in the JAX
  package; the labels exactly) and the same affines (1e-9).
- Its loss, ``DiceLoss(sigmoid=True, squared_pred=True, smooth_nr=0, smooth_dr=1e-5)``,
  and its metric, ``MeanDice(include_background=True)`` over the sigmoid outputs at a
  threshold of 0.5 with 3 channels, against the JAX package's: the loss within 1e-6
  relative, the dice within 1e-12 (float64 sums of the same counts).
- The bundle's ``train.json`` through the port's runner, its command line parsed as
  ``python -m monai_tpu_torch.bundle run`` parses it: 4 synthetic images, one epoch, roi
  32, the file's own SegResNet; it trains, validates (``val_mean_dice`` finite in [0, 1])
  and writes ``models/model_final.ckpt``.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monai_tpu.transforms as jax_transforms
import monai_tpu.utils as jax_utils
import monai_tpu_torch.transforms as transforms
import monai_tpu_torch.utils as utils
from monai_tpu.losses import DiceLoss as JaxDiceLoss
from monai_tpu.metrics import DiceMetric as JaxDiceMetric
from monai_tpu_torch.apps.datasets import make_synthetic_datalist
from monai_tpu_torch.data import MetaImage
from monai_tpu_torch.losses import DiceLoss
from monai_tpu_torch.metrics import DiceMetric
from monai_tpu_torch.networks.nets import SegResNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_JSON = os.path.join(REPO, "bundles", "brats_segresnet", "configs", "train.json")


def _pipeline(module, device_kw: dict, roi: int = 32):
    m = module
    return m.Compose([
        m.LoadImaged(keys=["image", "label"], **device_kw),
        m.EnsureChannelFirstd(keys="image"),
        m.ConvertToMultiChannelBasedOnBratsClassesd(keys="label"),
        m.Orientationd(keys=["image", "label"], axcodes="RAS"),
        m.Spacingd(keys=["image", "label"], pixdim=[1.0, 1.0, 1.0], mode=["bilinear", "nearest"]),
        m.RandSpatialCropd(keys=["image", "label"], roi_size=[roi] * 3, random_size=False),
        m.RandFlipd(keys=["image", "label"], prob=0.5, spatial_axis=0),
        m.NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        m.RandScaleIntensityd(keys="image", factors=0.1, prob=1.0),
        m.RandShiftIntensityd(keys="image", offsets=0.1, prob=1.0),
    ])


def test_the_pipeline_above_is_the_bundles():
    cfg = json.load(open(TRAIN_JSON))["preprocessing"]["transforms"]
    names = [t.__class__.__name__ for t in _pipeline(transforms, {"device": "cpu"}).transforms]
    assert names == [t["_target_"] for t in cfg]


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    return make_synthetic_datalist(str(root), num_images=1, spatial_size=(64, 64, 64), num_seg_classes=3)["training"][0]


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_brats_preprocessing_matches_jax(phantom, seed):
    jax_utils.set_determinism(seed=seed)
    ref_pipe = _pipeline(jax_transforms, {})
    utils.set_determinism(seed=seed)
    pipe = _pipeline(transforms, {"device": "cpu"})
    origins = set()
    for _ in range(3):
        ref, out = ref_pipe(dict(phantom)), pipe(dict(phantom))
        origins.add(tuple(out["image"].affine[:3, 3]))
        for key, tol in (("image", 1e-5), ("label", 0.0)):
            a, b = np.asarray(ref[key].data), out[key].data.numpy()
            assert isinstance(out[key], MetaImage) and a.shape == b.shape
            assert np.abs(a - b).max() <= tol * np.abs(a).max(), key
            np.testing.assert_allclose(out[key].affine, np.asarray(ref[key].affine), atol=1e-9)
        assert out["image"].data.shape == (1, 32, 32, 32) and out["label"].data.shape == (3, 32, 32, 32)
    assert len(origins) > 1  # the crops moved


def test_dice_loss_and_mean_dice_on_sigmoids_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 3, 12, 10, 8).astype(np.float32) * 2
    labels = (rng.rand(2, 3, 12, 10, 8) > 0.7).astype(np.float32)
    labels[1, 2] = 0.0  # an empty channel: ignored by the mean dice
    kw = dict(smooth_nr=0, smooth_dr=1e-5, squared_pred=True, to_onehot_y=False, sigmoid=True)
    ref = float(JaxDiceLoss(**kw)(jnp.asarray(logits), jnp.asarray(labels)))
    got = DiceLoss(**kw)(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    assert abs(got - ref) <= 1e-6 * abs(ref)
    pred = (1 / (1 + np.exp(-logits)) >= 0.5).astype(np.float32)
    ref_metric, metric = JaxDiceMetric(include_background=True), DiceMetric(include_background=True)
    for i in range(2):  # one volume a call, as the evaluator's MeanDice takes them
        ref_metric(jnp.asarray(pred[i:i + 1]), jnp.asarray(labels[i:i + 1]))
        metric(torch.from_numpy(pred[i:i + 1]), torch.from_numpy(labels[i:i + 1]))
    ref_dice, dice = float(np.asarray(ref_metric.aggregate())), float(metric.aggregate())
    assert np.isfinite(dice) and abs(dice - ref_dice) <= 1e-12


def test_brats_train_json_through_the_port_runner(tmp_path):
    cfg = json.load(open(TRAIN_JSON))
    imports = [i.replace("monai_tpu.", "monai_tpu_torch.") for i in cfg["imports"]]
    args = ["--bundle_root", str(tmp_path), "--imports", json.dumps(imports),
            "--initialize", json.dumps(["$import monai_tpu_torch", "$monai_tpu_torch.utils.set_determinism(seed=0)"]),
            "--optimizer", json.dumps({"_target_": "torch.optim.AdamW", "_mode_": "partial", "lr": 1e-4,
                                       "weight_decay": 1e-5}),
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
    assert trainer.state.iteration == 3 and isinstance(trainer.optimizer, torch.optim.AdamW)
    dice = wf.parser.get_parsed_content("evaluator").state.metrics["val_mean_dice"]
    assert np.isfinite(dice) and 0.0 <= dice <= 1.0
    net = SegResNet(3, init_filters=16, in_channels=1, out_channels=3, dropout_prob=0.2, device="cpu")
    net.load_state_dict(torch.load(tmp_path / "models" / "model_final.ckpt", weights_only=True)["model"])
    trained = wf.parser.get_parsed_content("network")
    assert type(trained) is SegResNet and type(trained.dropout) is torch.nn.Dropout
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(), trained.state_dict().values()))
