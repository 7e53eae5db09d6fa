"""The BTCV training bundle's data, handlers and runner in monai_tpu_torch, on the CPU.

- The bundle's preprocessing (``bundles/btcv_swinunetr/configs/train.json``, at
  ``roi_size`` 32) on one synthetic 64^3 file made with the same seed by each package:
  the files byte for byte, then for several seeds the four crops, their flips, rotations
  and shifts, against the JAX package's: identical shapes, values within 1e-6 (the same
  slices of the same float32 voxels, the shift added in float32), affines within 1e-9.
- ``CacheDataset`` hands out copies, ``list_data_collate`` flattens the samples, the
  ``CheckpointSaver`` file loads back through ``CheckpointLoader``, the trainer runs the
  bundle's three handlers, and the bundle's ``train.json`` runs through the port's runner
  at the JAX package's test overrides.
"""
import gzip
import json
import os

import numpy as np
import pytest
import torch

import monai_tpu.transforms as jax_transforms
import monai_tpu.utils as jax_utils
import monai_tpu_torch.transforms as transforms
import monai_tpu_torch.utils as utils
from monai_tpu.apps.datasets import make_synthetic_datalist as jax_make_synthetic_datalist
from monai_tpu_torch.apps.datasets import load_decathlon_datalist, make_synthetic_datalist
from monai_tpu_torch.data import CacheDataset, DataLoader, MetaImage, list_data_collate
from monai_tpu_torch.engines import SupervisedTrainer
from monai_tpu_torch.handlers import CheckpointLoader, CheckpointSaver, MeanDice, StatsHandler, ValidationHandler
from monai_tpu_torch.losses import DiceCELoss
from monai_tpu_torch.networks.nets import SwinUNETR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_JSON = os.path.join(REPO, "bundles", "btcv_swinunetr", "configs", "train.json")


def _pipeline(module, device_kw: dict, roi: int = 32):
    m = module
    return m.Compose([
        m.LoadImaged(keys=["image", "label"], **device_kw),
        m.EnsureChannelFirstd(keys=["image", "label"]),
        m.Orientationd(keys=["image", "label"], axcodes="RAS"),
        m.Spacingd(keys=["image", "label"], pixdim=[1.5, 1.5, 2.0], mode=["bilinear", "nearest"]),
        m.ScaleIntensityRanged(keys="image", a_min=-175, a_max=250, b_min=0.0, b_max=1.0, clip=True),
        m.CropForegroundd(keys=["image", "label"], source_key="image"),
        m.RandCropByPosNegLabeld(keys=["image", "label"], label_key="label", spatial_size=[roi] * 3, pos=1, neg=1,
                                 num_samples=4, image_key="image"),
        m.RandFlipd(keys=["image", "label"], spatial_axis=0, prob=0.1),
        m.RandFlipd(keys=["image", "label"], spatial_axis=1, prob=0.1),
        m.RandFlipd(keys=["image", "label"], spatial_axis=2, prob=0.1),
        m.RandRotate90d(keys=["image", "label"], prob=0.1, max_k=3),
        m.RandShiftIntensityd(keys="image", offsets=0.1, prob=0.5),
    ])


def test_the_pipeline_file_matches_the_bundles():
    """The transforms above are the bundle's own, in its order, with its arguments."""
    cfg = json.load(open(TRAIN_JSON))["preprocessing"]["transforms"]
    names = [t.__class__.__name__ for t in _pipeline(transforms, {"device": "cpu"}).transforms]
    assert names == [t["_target_"] for t in cfg]


@pytest.fixture(scope="module")
def synthetic_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("btcv")
    kw = dict(num_images=1, spatial_size=(64, 64, 64), num_seg_classes=3, overwrite=True)
    return (jax_make_synthetic_datalist(str(root / "jax"), **kw)["training"][0],
            make_synthetic_datalist(str(root / "port"), **kw)["training"][0])


def test_synthetic_phantoms_match_jax_byte_for_byte(synthetic_files):
    ref, got = synthetic_files
    for key in ("image", "label"):
        with gzip.open(ref[key]) as a, gzip.open(got[key]) as b:
            assert a.read() == b.read(), key


@pytest.mark.parametrize("seed", [0, 7, 12])
def test_btcv_preprocessing_matches_jax(synthetic_files, seed):
    ref_item, item = synthetic_files
    jax_utils.set_determinism(seed=seed)
    ref_pipe = _pipeline(jax_transforms, {})
    utils.set_determinism(seed=seed)
    pipe = _pipeline(transforms, {"device": "cpu"})
    acted = {7: 0, 8: 0, 9: 0, 10: 0, 11: 0}  # the random transforms' draws that acted
    for i in acted:
        t = pipe.transforms[i]
        t.randomize = (lambda draw, i, t: lambda data=None: (draw(data), acted.__setitem__(
            i, acted[i] + bool(t.t._do_transform))))(t.randomize, i, t)
    for _ in range(3):
        refs, outs = ref_pipe(dict(ref_item)), pipe(dict(item))
        assert len(refs) == len(outs) == 4
        for i, (r, o) in enumerate(zip(refs, outs)):
            for key in ("image", "label"):
                a, b = np.asarray(r[key].data), o[key].data.numpy()
                assert isinstance(o[key], MetaImage) and a.shape == b.shape == (1, 32, 32, 32)
                assert np.abs(a - b).max() <= 1e-6, (key, i)
                np.testing.assert_allclose(o[key].affine, np.asarray(r[key].affine), atol=1e-9)
                assert o[key].meta["patch_index"] == i
    assert acted[11] > 0 and sum(acted[i] for i in (7, 8, 9, 10)) > 0, acted  # some crops were moved and shifted


def test_cache_dataset_hands_out_copies(synthetic_files):
    _, item = synthetic_files
    utils.set_determinism(seed=0)
    data = CacheDataset([dict(item)] * 2, _pipeline(transforms, {"device": "cpu"}), cache_rate=0.5,
                        num_workers=2)
    assert data.cache_num == 1 and data._start == 6
    cached = data._cache[0]["image"].data.clone()
    crops = data[0]
    for c in crops:
        c["image"].data.add_(1000.0)  # a change to what was handed out
    assert torch.equal(data._cache[0]["image"].data, cached)
    assert data._cache[0]["image"].data.data_ptr() not in {c["image"].data.data_ptr() for c in crops}
    assert len(data[1]) == 4  # past the cache: the whole pipeline


def test_list_data_collate_flattens_the_samples():
    items = [[{"image": MetaImage(torch.full((1, 2, 2, 2), float(i * 4 + s))), "n": s} for s in range(4)]
             for i in range(2)]
    batch = list_data_collate(items)
    assert batch["image"].data.shape == (8, 1, 2, 2, 2) and batch["image"].is_batch
    assert batch["image"].data[:, 0, 0, 0, 0].tolist() == list(range(8))
    assert batch["n"].tolist() == [0, 1, 2, 3] * 2
    loader = DataLoader([[{"x": torch.zeros(2)}] * 4], batch_size=1)
    assert next(iter(loader))["x"].shape == (4, 2)


def test_checkpoint_saver_round_trip(tmp_path):
    net = SwinUNETR(1, 3, feature_size=12, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = SupervisedTrainer(device="cpu", max_epochs=1, train_data_loader=[], network=net,
                                optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4))
    saver = CheckpointSaver(str(tmp_path / "models"), {"model": net}, save_final=True,
                            final_filename="model_final.ckpt")
    saver.attach(trainer)
    trainer.state.iteration = 3
    saver.completed(trainer)
    fresh = SwinUNETR(1, 3, feature_size=12, device="cpu", generator=torch.Generator().manual_seed(1))
    assert not torch.equal(fresh.out.conv.conv.weight, net.out.conv.conv.weight)
    CheckpointLoader(str(tmp_path / "models" / "model_final.ckpt"), {"model": fresh})(trainer)
    for (k, a), b in zip(net.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert isinstance(trainer.optimizer, torch.optim.AdamW)


def test_trainer_runs_its_handlers_and_validation(tmp_path):
    """A float32 SwinUNETR trainer with the bundle's three handlers on a tiny batch: the
    validation's mean dice lands in the evaluator's metrics, the loss is logged, the
    checkpoint is written."""
    from monai_tpu_torch.engines import SupervisedEvaluator
    from monai_tpu_torch.inferers import SlidingWindowInferer
    from monai_tpu_torch.transforms import Activationsd, AsDiscreted, Compose

    net = SwinUNETR(1, 3, feature_size=12, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.rand(2, 1, 32, 32, 32).astype(np.float32)),
             "label": torch.from_numpy(rng.randint(0, 3, (2, 1, 32, 32, 32)).astype(np.float32))}
    post = Compose([Activationsd(keys="pred", softmax=True), AsDiscreted(keys="pred", argmax=True, to_onehot=3),
                    AsDiscreted(keys="label", to_onehot=3)])
    evaluator = SupervisedEvaluator(device="cpu", val_data_loader=[batch], network=net,
                                    inferer=SlidingWindowInferer(32, 1, 0.5), postprocessing=post,
                                    key_val_metric={"val_mean_dice": MeanDice(include_background=False)})
    logged = []
    stats = StatsHandler(tag_name="train_loss", name="swin_training_test")
    stats.logger.addHandler(type(stats.logger.handlers[0])(stream=type("S", (), {"write": logged.append,
                                                                                   "flush": lambda self: None})()))
    trainer = SupervisedTrainer(device="cpu", max_epochs=1, train_data_loader=[batch], network=net,
                                optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4, weight_decay=1e-5),
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True),
                                train_handlers=[ValidationHandler(1, evaluator), stats,
                                                CheckpointSaver(str(tmp_path), {"model": net}, save_final=True,
                                                                final_filename="model_final.ckpt")])
    trainer.run()
    dice = evaluator.state.metrics["val_mean_dice"]
    assert np.isfinite(dice) and 0.0 <= dice <= 1.0
    assert any("train_loss" in line for line in logged)
    assert os.path.exists(tmp_path / "model_final.ckpt")


def test_load_decathlon_datalist(tmp_path):
    (tmp_path / "dataset_0.json").write_text(json.dumps({
        "training": [{"image": "imagesTr/a.nii.gz", "label": "labelsTr/a.nii.gz"}], "test": ["imagesTs/b.nii.gz"]}))
    train = load_decathlon_datalist(str(tmp_path / "dataset_0.json"), True, "training")
    assert train == [{"image": str(tmp_path / "imagesTr" / "a.nii.gz"), "label": str(tmp_path / "labelsTr" / "a.nii.gz")}]
    assert load_decathlon_datalist(str(tmp_path / "dataset_0.json"), True, "test") == [
        {"image": str(tmp_path / "imagesTs" / "b.nii.gz")}]


def test_btcv_train_json_through_the_port_runner(tmp_path):
    """The bundle's own train.json, through ``python -m monai_tpu_torch.bundle run`` on the
    CPU, at the JAX package's test overrides (4 synthetic images, one epoch, roi 32,
    feature size 12): it trains, validates and writes ``models/model_final.ckpt``."""
    imports = ["$import os", "$from monai_tpu_torch.apps.datasets import make_synthetic_datalist",
               "$from monai_tpu_torch.apps.datasets import load_decathlon_datalist",
               "$from monai_tpu_torch.handlers import from_engine"]
    args = ["--bundle_root", str(tmp_path), "--imports", json.dumps(imports),
            "--initialize", json.dumps(["$import monai_tpu_torch", "$monai_tpu_torch.utils.set_determinism(seed=0)"]),
            "--optimizer", json.dumps({"_target_": "torch.optim.AdamW", "_mode_": "partial", "lr": 1e-4,
                                       "weight_decay": 1e-5}),
            "--num_synth_images", "4", "--epochs", "1", "--roi_size", "[32, 32, 32]", "--network::feature_size", "12",
            "--network::device", "cpu", "--trainer::device", "cpu", "--evaluator::device", "cpu",
            "--preprocessing::transforms::0::device", "cpu", "--val_preprocessing::transforms::0::device", "cpu"]
    from monai_tpu_torch.bundle.__main__ import parse_args
    from monai_tpu_torch.bundle.workflows import ConfigWorkflow

    _, kwargs = parse_args(args)
    wf = ConfigWorkflow(config_file=TRAIN_JSON, workflow_type=None, **kwargs)
    wf.initialize()
    wf.run()
    dice = wf.parser.get_parsed_content("evaluator").state.metrics["val_mean_dice"]
    assert np.isfinite(dice) and 0.0 <= dice <= 1.0
    ckpt = tmp_path / "models" / "model_final.ckpt"
    net = SwinUNETR(1, 4, feature_size=12, device="cpu")
    net.load_state_dict(torch.load(ckpt, weights_only=True)["model"])
    trained = wf.parser.get_parsed_content("network")
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(), trained.state_dict().values()))
