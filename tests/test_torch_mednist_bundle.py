"""The MedNIST bundle's train.json through monai_tpu_torch's runner, on the CPU.

``bundles/mednist_classification/configs/train.json`` as it stands, its command line parsed
as ``python -m monai_tpu_torch.bundle run`` parses it, overriding its bundle root, its
``imports`` and ``initialize`` (the port's), its optimizer (``optax.adam`` becomes
``torch.optim.Adam`` at the file's 1e-5), and the five ``device cpu`` entries; at
``num_synth_images`` 16 with ``num_classes`` 4 (12 training and 4 validation images, each
class once among the 4, as the JAX package's own bundle test runs it: with six classes the
validation images would hold four of them, and the absent classes' AUC is NaN in both
packages) and one epoch. The file's own pieces run: the synthetic 64x64 NIfTI images,
``CacheDataset`` up to ``RandRotated``, ``DenseNet121(2, 1, 4)``, ``CrossEntropyLoss``,
batch 8 with shuffle, the validation with ``ROCAUC``, the checkpoint. Checked: two training
iterations of (8, 1, 64, 64) and (4, 1, 64, 64) float32 images with int64 labels, finite
losses, ``val_rocauc`` in [0, 1], and ``models/model_final.ckpt`` loading into a fresh
``DenseNet121`` equal to the trained network.
"""
import json
import os

import numpy as np
import torch

from monai_tpu_torch.networks.nets import DenseNet121

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_JSON = os.path.join(REPO, "bundles", "mednist_classification", "configs", "train.json")


def test_mednist_train_json_through_the_port_runner(tmp_path):
    cfg = json.load(open(TRAIN_JSON))
    imports = [i.replace("monai_tpu.", "monai_tpu_torch.") for i in cfg["imports"]]
    args = ["--bundle_root", str(tmp_path), "--imports", json.dumps(imports),
            "--initialize", json.dumps(["$import monai_tpu_torch", "$monai_tpu_torch.utils.set_determinism(seed=0)"]),
            "--optimizer", json.dumps({"_target_": "torch.optim.Adam", "_mode_": "partial", "lr": 1e-5}),
            "--num_synth_images", "16", "--num_classes", "4", "--epochs", "1",
            "--network::device", "cpu", "--trainer::device", "cpu", "--evaluator::device", "cpu",
            "--preprocessing::transforms::0::device", "cpu", "--val_preprocessing::transforms::0::device", "cpu"]
    from monai_tpu_torch.bundle.__main__ import parse_args
    from monai_tpu_torch.bundle.workflows import ConfigWorkflow
    from monai_tpu_torch.engines import Events

    _, kwargs = parse_args(args)
    wf = ConfigWorkflow(config_file=TRAIN_JSON, workflow_type=None, **kwargs)
    wf.initialize()
    trainer = wf.parser.get_parsed_content("trainer")
    batches, losses = [], []
    trainer.add_event_handler(Events.ITERATION_COMPLETED, lambda engine: (
        batches.append((tuple(engine.state.batch["image"].data.shape), engine.state.batch["image"].data.dtype,
                        tuple(engine.state.batch["label"].shape), engine.state.batch["label"].dtype)),
        losses.append(engine.state.output["loss"].item())))
    wf.run()
    assert isinstance(trainer.optimizer, torch.optim.Adam) and trainer.optimizer.defaults["lr"] == 1e-5
    assert len(trainer.data_loader.dataset) == 12 and len(trainer.data_loader.dataset._cache) == 12
    assert batches == [((8, 1, 64, 64), torch.float32, (8,), torch.int64),
                       ((4, 1, 64, 64), torch.float32, (4,), torch.int64)]
    assert all(np.isfinite(v) for v in losses)
    auc = wf.parser.get_parsed_content("evaluator").state.metrics["val_rocauc"]
    assert np.isfinite(auc) and 0.0 <= auc <= 1.0
    net = DenseNet121(2, 1, 4, device="cpu")
    net.load_state_dict(torch.load(tmp_path / "models" / "model_final.ckpt", weights_only=True)["model"])
    trained = wf.parser.get_parsed_content("network")
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(), trained.state_dict().values()))
