"""The port's data pipeline pieces against monai_tpu's, on the CPU: collation and
decollation of preprocessed Spleen items, the threaded DataLoader's order, SaveImaged's
file, and CheckpointLoader on a torch file made from a JAX batch-norm UNet.

Two 64x64x20 int16 CTs (the recipe of tests/test_torch_spleen_inference.py, at two
noise seeds) go through the bundle's preprocessing in both packages; collated, both
batches hold the same shapes, values (1e-5), affines (1e-9) and applied-operation
classes per item, and decollated each item gets its own back, so that Invertd can run
after decollation.
"""
import threading
import time

import numpy as np
import pytest
import torch

from flax import nnx

from monai_tpu.data.utils import decollate_batch as jax_decollate_batch
from monai_tpu.data.utils import list_data_collate as jax_list_data_collate
from monai_tpu.data.nifti import read_nifti as jax_read_nifti
from monai_tpu.data.meta_image import MetaImage as JaxMetaImage
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu.transforms import compose as jax_compose
from monai_tpu.transforms import dictionary as jax_dict
from monai_tpu_torch.data import (DataLoader, Dataset, FolderLayout, MetaImage, decollate_batch, list_data_collate,
                                  read_nifti, write_nifti)
from monai_tpu_torch.engines import State
from monai_tpu_torch.handlers import CheckpointLoader
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax
from monai_tpu_torch.transforms import (Compose, EnsureChannelFirstd, Invertd, LoadImaged, Orientationd, SaveImaged,
                                        ScaleIntensityRanged, Spacingd)

AFFINE = np.diag([-0.79, -0.79, 5.0, 1.0])


def write_ct(path, seed: int) -> None:
    rng = np.random.RandomState(seed)
    x, y, z = np.meshgrid(np.linspace(-1, 1, 64), np.linspace(-1, 1, 64), np.linspace(-1, 1, 20), indexing="ij")
    body = np.where(x ** 2 + y ** 2 < 0.8, 40.0, -1000.0) + 120.0 * np.exp(-((x - 0.3) ** 2 + y ** 2 + z ** 2) / 0.1)
    write_nifti((body + rng.normal(0, 30, body.shape)).astype(np.int16), path, affine=AFFINE)


def pipeline(ns, **load_kwargs):
    return ns.Compose([ns.LoadImaged("image", **load_kwargs), ns.EnsureChannelFirstd("image"),
                       ns.Orientationd("image", axcodes="RAS"), ns.Spacingd("image", pixdim=[1.5, 1.5, 2.0]),
                       ns.ScaleIntensityRanged("image", a_min=-57, a_max=164, b_min=0.0, b_max=1.0, clip=True)])


class _Jax:
    Compose, LoadImaged, EnsureChannelFirstd = jax_compose.Compose, jax_dict.LoadImaged, jax_dict.EnsureChannelFirstd
    Orientationd, Spacingd, ScaleIntensityRanged = jax_dict.Orientationd, jax_dict.Spacingd, jax_dict.ScaleIntensityRanged


class _Port:
    Compose, LoadImaged, EnsureChannelFirstd = Compose, LoadImaged, EnsureChannelFirstd
    Orientationd, Spacingd, ScaleIntensityRanged = Orientationd, Spacingd, ScaleIntensityRanged


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    root = tmp_path_factory.mktemp("cts")
    paths = [str(root / f"ct_{i}.nii.gz") for i in range(2)]
    for i, p in enumerate(paths):
        write_ct(p, i)
    jax_pre, pre = pipeline(_Jax), pipeline(_Port, device="cpu")
    return [jax_pre({"image": p}) for p in paths], [pre({"image": p}) for p in paths]


def test_collate_matches_jax(items):
    jax_items, port_items = items
    jb, b = jax_list_data_collate(jax_items)["image"], list_data_collate(port_items)["image"]
    assert b.is_batch and jb.is_batch and b.shape == tuple(jb.shape) == (2, 1, 34, 34, 48)
    assert b.affine.shape == (2, 4, 4) and np.abs(b.affine - np.asarray(jb.affine)).max() <= 1e-9
    assert np.abs(b.as_numpy() - np.asarray(jb.data)).max() <= 1e-5
    assert [[op["class"] for op in ops] for ops in b.applied_operations] == \
        [[op["class"] for op in ops] for ops in jb.applied_operations] == [["Orientation", "Spacing"]] * 2
    assert [m["filename_or_obj"] for m in b.meta["batched_meta"]] == \
        [m["filename_or_obj"] for m in jb.meta["batched_meta"]]


def test_decollate_gives_each_item_back_as_jax_does(items):
    jax_items, port_items = items
    jout = jax_decollate_batch({**jax_list_data_collate(jax_items), "label": None})
    out = decollate_batch({**list_data_collate(port_items), "label": None})
    assert len(out) == len(jout) == 2
    for d, jd, item in zip(out, jout, port_items):
        img, jimg = d["image"], jd["image"]
        assert d["label"] is None and jd["label"] is None
        assert isinstance(img, MetaImage) and not img.is_batch and img.shape == tuple(jimg.shape) == (1, 34, 34, 48)
        assert torch.equal(img.data, item["image"].data)
        assert np.abs(img.affine - np.asarray(jimg.affine)).max() <= 1e-9
        assert np.array_equal(img.affine, item["image"].affine)
        assert [op["class"] for op in img.applied_operations] == [op["class"] for op in jimg.applied_operations]
        assert img.meta["filename_or_obj"] == jimg.meta["filename_or_obj"] == item["image"].meta["filename_or_obj"]


def test_invertd_runs_after_decollation(items):
    """A decollated item carries what Invertd needs: a label map on its grid comes back
    to the file's 64x64x20 grid and affine."""
    _, port_items = items
    pre = pipeline(_Port, device="cpu")
    batch = list_data_collate(port_items)
    out = decollate_batch({**batch, "pred": (batch["image"].data > 0.5).float()})
    for d in out:
        inv = Invertd("pred", transform=pre, orig_keys="image")(d)["pred"]
        assert inv.shape == (1, 64, 64, 20) and inv.applied_operations == []
        assert np.abs(inv.affine - read_nifti(d["image"].meta["filename_or_obj"])[1]["affine"]).max() <= 1e-9
        assert inv.meta["filename_or_obj"] == d["image"].meta["filename_or_obj"]


def test_collate_of_one_item_is_a_copy():
    """A batch of one does not alias its item (monai_tpu's batch-1 collate returns a view)."""
    item = {"image": MetaImage(torch.zeros(1, 2, 3, 4)), "n": 3}
    batch = list_data_collate([item])
    batch["image"].data += 1
    assert float(item["image"].data.abs().max()) == 0.0 and batch["n"].tolist() == [3]
    jitem = {"image": JaxMetaImage(np.zeros((1, 2, 3, 4), np.float32))}
    assert np.shares_memory(np.asarray(jax_list_data_collate([jitem])["image"].data), np.asarray(jitem["image"].data))


@pytest.mark.parametrize("pad", [True, False])
def test_decollate_pads_and_numbers_as_jax(pad):
    """Values that are not batched repeat for each item, shorter ones are filled, 0-d
    rows become numbers: the same items as monai_tpu's decollate_batch."""
    batch = {"a": np.arange(3), "b": "x", "c": [np.ones(2), np.zeros(2)], "d": None}
    if not pad:  # unpadded, every value must be batched
        del batch["b"], batch["d"]
    out = decollate_batch({k: torch.as_tensor(v) if isinstance(v, np.ndarray) else
                           [torch.as_tensor(x) for x in v] if isinstance(v, list) else v for k, v in batch.items()},
                          pad=pad, fill_value=-1)
    ref = jax_decollate_batch(batch, pad=pad, fill_value=-1)
    assert out == ref and len(out) == (3 if pad else 2)
    assert out[0] == ({"a": 0, "b": "x", "c": [1.0, 0.0], "d": None} if pad else {"a": 0, "c": [1.0, 0.0]})
    assert decollate_batch(3) == 3 and decollate_batch({"a": "x"}) == {"a": "x"}


class _Slow:
    """Items that take a random time to read, from more than one thread at once."""

    def __init__(self, n: int):
        self.n, self.threads = n, set()
        self.rng = np.random.RandomState(0)
        self.delays = self.rng.uniform(0, 0.02, n)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.threads.add(threading.get_ident())
        time.sleep(self.delays[i])
        return {"image": MetaImage(torch.full((1, 2, 2), float(i))), "i": i}


@pytest.mark.parametrize("batch_size,drop_last", [(1, False), (2, False), (2, True)])
def test_dataloader_threads_keep_the_order(batch_size, drop_last):
    ref = list(DataLoader(_Slow(7), batch_size=batch_size, drop_last=drop_last))
    data = _Slow(7)
    got = list(DataLoader(data, batch_size=batch_size, num_workers=2, drop_last=drop_last, prefetch=2))
    assert len(got) == len(ref) == len(DataLoader(data, batch_size=batch_size, drop_last=drop_last))
    assert len(data.threads - {threading.get_ident()}) >= 1  # read by the workers
    for a, b in zip(got, ref):
        assert torch.equal(a["image"].data, b["image"].data) and torch.equal(a["i"], b["i"])
    assert [int(i) for b in got for i in b["i"]] == list(range(7 if not drop_last else 6))


def test_dataloader_shuffles_from_torch_seed():
    torch.manual_seed(4)
    a = [int(b["i"][0]) for b in DataLoader(_Slow(6), shuffle=True)]
    torch.manual_seed(4)
    b = [int(b["i"][0]) for b in DataLoader(_Slow(6), shuffle=True, num_workers=2)]
    assert a == b and sorted(a) == list(range(6)) and a != list(range(6))


def test_dataloader_raises_a_worker_error():
    class Bad(_Slow):
        def __getitem__(self, i):
            if i == 3:
                raise ValueError("bad item")
            return super().__getitem__(i)

    with pytest.raises(ValueError, match="bad item"):
        list(DataLoader(Bad(5), num_workers=2))


def test_dataset_transforms_each_read(items):
    data = Dataset([{"x": 1}, {"x": 2}, {"x": 3}], transform=lambda d: {"x": d["x"] * 10})
    assert len(data) == 3 and data[1] == {"x": 20} and [d["x"] for d in data[1:]] == [20, 30]
    assert Dataset([1, 2])[0] == 1


def test_saveimaged_matches_jax(tmp_path, items):
    """The same label array with the same meta through both packages' SaveImaged: the
    same relative file name, header and voxels."""
    _, port_items = items
    image = port_items[0]["image"]
    labels = (image.data > 0.4).float()
    meta = {k: v for k, v in image.meta.items()}
    d = SaveImaged("pred", output_dir=str(tmp_path / "port"), output_postfix="seg", resample=False, print_log=False)(
        {"pred": MetaImage(labels, affine=image.affine, meta=meta)})
    jax_dict.SaveImaged("pred", output_dir=str(tmp_path / "jax"), output_postfix="seg", resample=False,
                        print_log=False)({"pred": JaxMetaImage(labels.numpy(), affine=image.affine, meta=dict(meta))})
    assert torch.equal(d["pred"].data, labels)
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.nii.gz"))
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.nii.gz"))
    assert [str(f) for f in port_files] == [str(f) for f in jax_files] == ["ct_0/ct_0_seg.nii.gz"]
    got, gmeta = read_nifti(tmp_path / "port" / port_files[0])
    ref, rmeta = jax_read_nifti(tmp_path / "jax" / jax_files[0])
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (34, 34, 48)
    assert np.abs(gmeta["affine"] - rmeta["affine"]).max() <= 1e-6  # the header's float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, labels[0].numpy())


def test_folder_layout():
    layout = FolderLayout("/out", postfix="seg", extension=".nii.gz", parent=True)
    assert layout.filename("/data/imagesTs/spleen_3.nii.gz") == "/out/spleen_3/spleen_3_seg.nii.gz"
    assert FolderLayout("/out", "p", "nii").filename("a/b.nii", idx=2, k=1) == "/out/b_p_2_k-1.nii"


@pytest.fixture(scope="module")
def bridged_weights():
    """A JAX batch-norm UNet's variables (built abstractly, values from numpy, running
    statistics away from 0 and 1) through the weight bridge."""
    jax_net = nnx.eval_shape(lambda: JaxUNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, norm="batch",
                                             rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(7)
    variables = {}
    for kind in (nnx.Param, nnx.BatchStat):
        for path, var in nnx.state(jax_net, kind).flat_state():
            shape = var.get_value().shape
            lo, hi = {"mean": (-0.3, 0.3), "var": (0.2, 2.0)}.get(path[-1], (-1.0, 1.0))
            variables[".".join(map(str, path))] = rng.uniform(lo, hi, shape).astype(np.float32)
    return unet_state_dict_from_jax(variables)


class _Engine:
    def __init__(self):
        self.state = State(device=torch.device("cpu"))


@pytest.mark.parametrize("form", ["dict", "bare"])
def test_checkpoint_loader_loads_a_bridged_jax_unet(tmp_path, bridged_weights, form):
    path = tmp_path / "model.pt"
    torch.save({"model": bridged_weights} if form == "dict" else bridged_weights, path)
    net = UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, norm="batch", device="cpu")
    CheckpointLoader(str(path), {"model": net}, strict=True)(_Engine())
    state = net.state_dict()
    assert set(state) == set(bridged_weights)
    assert all(torch.equal(state[k], bridged_weights[k]) for k in state)
    running = [k for k in state if k.endswith("running_var")]
    assert running and all(not torch.equal(state[k], torch.ones_like(state[k])) for k in running)


def test_checkpoint_loader_strict_raises_on_a_missing_key(tmp_path, bridged_weights):
    partial = dict(bridged_weights)
    partial.pop(next(k for k in partial if k.endswith("running_mean")))
    torch.save({"model": partial}, tmp_path / "model.pt")
    net = UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, norm="batch", device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        CheckpointLoader(str(tmp_path / "model.pt"), {"model": net}, strict=True)(_Engine())
    CheckpointLoader(str(tmp_path / "model.pt"), {"model": net}, strict=False)(_Engine())
    torch.save({"model": bridged_weights}, tmp_path / "full.pt")
    with pytest.raises(KeyError, match="other"):
        CheckpointLoader(str(tmp_path / "full.pt"), {"model": net, "other": net}, strict=True)(_Engine())


def test_supervised_evaluator_decollates_postprocesses_and_restores_the_mode():
    """Each iteration's output becomes one dict an item, each postprocessed, the batch
    decollated beside it; the metrics take the items stacked; the network is in eval
    mode for the run and back in train mode after; with amp the input is cast to bfloat16
    and the network's strided first conv promotes it back to float32 (the JAX evaluator's
    rule), so the prediction is the float32 forward of the rounded input."""
    from monai_tpu_torch.engines import Events, SupervisedEvaluator
    from monai_tpu_torch.transforms import AsDiscreted

    net = UNet(3, 1, 2, (4, 8), (2,), num_res_units=1, norm="batch", device="cpu",
               generator=torch.Generator().manual_seed(0)).train()
    items = [{"image": MetaImage(torch.rand(1, 8, 8, 8, generator=torch.Generator().manual_seed(i))),
              "label": torch.ones(1, 8, 8, 8)} for i in range(4)]
    seen, modes = [], []

    class Metric:
        def __call__(self, pred, label):
            seen.append((tuple(pred.shape), tuple(label.shape)))

        def aggregate(self):
            return torch.tensor(0.5)

        def reset(self):
            pass

    evaluator = SupervisedEvaluator(device="cpu", val_data_loader=DataLoader(Dataset(items), batch_size=2), network=net,
                                    postprocessing=Compose([AsDiscreted("pred", argmax=True)]),
                                    key_val_metric={"m": Metric()})
    outputs = []
    evaluator.add_event_handler(Events.ITERATION_COMPLETED, lambda e: (outputs.append(e.state.output),
                                                                      modes.append(net.training)))
    evaluator.run()
    assert net.training and modes == [False, False] and evaluator.state.metrics == {"m": 0.5}
    assert [len(o) for o in outputs] == [2, 2] and seen == [((2, 1, 8, 8, 8), (2, 1, 8, 8, 8))] * 2
    assert isinstance(evaluator.state.batch, list) and len(evaluator.state.batch) == 2
    for out in outputs:
        for item in out:
            assert item["pred"].shape == (1, 8, 8, 8) and item["pred"].dtype == torch.float32
            assert set(item["pred"].unique().tolist()) <= {0.0, 1.0} and isinstance(item["image"], MetaImage)
    with torch.no_grad():
        ref = net.eval()(torch.stack([i["image"].data for i in items[:2]]))
    got = evaluator._iteration(evaluator, list_data_collate(items[:2]))["pred"]
    assert got.dtype == torch.float32 and (got - ref).abs().max() <= 1e-6
    amp = SupervisedEvaluator(device="cpu", val_data_loader=[], network=net, amp=True)
    got = amp._iteration(amp, list_data_collate(items[:2]))["pred"]
    with torch.no_grad():
        ref = net.eval()(torch.stack([i["image"].data for i in items[:2]]).to(torch.bfloat16).float())
    assert got.dtype == torch.float32 and torch.equal(got, ref)
