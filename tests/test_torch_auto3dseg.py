"""Auto3DSeg in monai_tpu_torch, on the CPU, against monai_tpu.

- ``DataAnalyzer`` on four 16^3 phantoms: the whole ``datastats.json`` equal to the JAX
  package's, shapes, spacings, labels and counts exactly and the intensities within 1e-6
  relative (the port sums in float64 and interpolates its percentiles in float64 between
  float32 order statistics; numpy sums the float32 array in float32).
- ``BundleAlgo.fill_template_config`` and ``BundleGen.generate`` for the unet, segresnet
  and swinunetr templates: the same keys and values as the JAX package's but for
  ``imports`` (torch, not optax) and ``optimizer`` (``torch.optim.AdamW`` with optax's
  adamw defaults, which the test reads), and the same fold splits.
- A generated bundle's ``train_transforms`` parsed by each package's ``ConfigParser`` from
  its own ``train.json``: the crops and flips of its first item under the same seed (the
  image within 1e-5 of max|ref|: ``NormalizeIntensityd`` sums in float64 here, float32
  there; the labels exactly).
- ``AlgoEnsembleBestN`` and ``AlgoEnsembleBestByFold`` pick the JAX package's members for
  the same scores; ``MeanEnsemble`` (with and without weights), ``VoteEnsemble`` and their
  dict forms give the JAX package's outputs within 1e-6.
- ``AutoRunner`` end to end through the bundle's ``run.json`` (the port alone: the JAX
  runner is slow on the CPU): roi 16^3, 1 epoch, batch 1, ``algos=["unet"]``; two trained
  bundles, their ``result.json`` and checkpoints, an ensemble whose prediction has the
  input's spatial shape; the history pickled and read back by ``EnsembleRunner``; and
  ``hpo=True``'s search over the default grid.
- No module of the port, nor ``chip_smoke.py``, imports jax, flax or monai_tpu.
- Fault C12: the group norm on the CPU, given kernel 1's channels-last output of a window
  of background (a group of 98% one value), within 1e-4 std of the float64 math, and so a
  SegResNet's forward on such a window (torch's CPU kernel on channels-last memory was
  4.2 std off it).
"""
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import monai_tpu.apps.auto3dseg as jax_a3d
import monai_tpu.bundle as jax_bundle
import monai_tpu.transforms as jax_transforms
import monai_tpu.utils as jax_utils
import copy

import monai_tpu_torch.transforms as transforms
import monai_tpu_torch.utils as utils
from monai_tpu.utils.enums import AlgoKeys as JaxAlgoKeys
from monai_tpu_torch.apps import auto3dseg as a3d
from monai_tpu_torch.data import write_nifti
from monai_tpu_torch.data.synthetic import create_test_image_3d
from monai_tpu_torch.bundle import ConfigParser, run
from monai_tpu_torch.networks.layers.factories import Norm
from monai_tpu_torch.networks.nets import SegResNet
from monai_tpu_torch.utils import AlgoKeys

REPO = Path(__file__).resolve().parents[1]
RUN_JSON = REPO / "bundles" / "auto3dseg" / "configs" / "run.json"
DIFFERS = {"imports", "optimizer"}  # the port's own items of a generated train.json


@pytest.fixture(scope="module")
def phantoms(tmp_path_factory):
    """Four 16^3 phantoms with their labels, written as make_synthetic_datalist writes them."""
    root = tmp_path_factory.mktemp("a3d")
    rs = np.random.RandomState(0)
    items = []
    for i in range(4):
        im, seg = create_test_image_3d(16, 16, 16, num_objs=4, rad_max=6, rad_min=2, num_seg_classes=1,
                                       random_state=rs)
        items.append({"image": str(root / f"img{i}.nii.gz"), "label": str(root / f"seg{i}.nii.gz")})
        write_nifti(im.astype(np.float32), items[-1]["image"])
        write_nifti(seg.astype(np.uint8), items[-1]["label"])
    return {"training": items}


def _close(got, ref, path=""):
    """Equal but for intensities, which agree within 1e-6 relative."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, f"{path}[{i}]")
    elif "intensity" in path and isinstance(ref, float):
        assert abs(got - ref) <= 1e-6 * max(abs(ref), 1e-6), (path, got, ref)
    else:
        assert got == ref and type(got) is type(ref), (path, got, ref)


def test_data_analyzer_matches_jax(phantoms, tmp_path):
    ref = jax_a3d.DataAnalyzer(phantoms, output_path=str(tmp_path / "jax.json"), fmt="json").get_all_case_stats()
    got = a3d.DataAnalyzer(phantoms, output_path=str(tmp_path / "port.json"), fmt="json",
                           device="cpu").get_all_case_stats()
    assert got["n_cases"] == 4 and got["stats_summary"]["label_stats"]["labels"] == [0, 1]
    _close(got, ref)
    _close(json.loads((tmp_path / "port.json").read_text()), json.loads((tmp_path / "jax.json").read_text()))


def test_analyzer_percentiles_are_numpys():
    """The percentiles from one sort, interpolated as numpy's "linear", at sizes whose
    positions fall between and on order statistics."""
    from monai_tpu_torch.apps.auto3dseg.analyzer import _percentiles

    rs = np.random.RandomState(3)
    for n in (1, 2, 7, 200, 1001):
        x = rs.randn(n).astype(np.float32)
        got = _percentiles(torch.from_numpy(x), (0.5, 50.0, 99.5))
        ref = [float(np.percentile(x.astype(np.float64), q)) for q in (0.5, 50.0, 99.5)]
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


STATS = {"stats_summary": {"image_stats": {"spacing": {"median": [2.0, 1.5, 3.0]},
                                           "intensity": {"mean": 0.3, "std": 0.2}},
                           "label_stats": {"labels": [0, 1, 2]}}}


@pytest.mark.parametrize("template", ["unet", "segresnet", "swinunetr"])
def test_template_config_matches_jax(template):
    params = {"roi_size": (32, 32, 32), "lr": 5e-4, "max_epochs": 3, "batch_size": 1}
    ref = jax_a3d.BundleAlgo(template).fill_template_config(STATS, **params)
    got = a3d.BundleAlgo(template).fill_template_config(STATS, **params)
    assert set(got) == set(ref)
    assert {k: got[k] for k in got if k not in DIFFERS} == {k: ref[k] for k in ref if k not in DIFFERS}
    assert ref["optimizer"] == "$optax.adamw(@lr)" and got["imports"] == ["$import torch"]
    import optax

    # optax's adamw defaults, which torch's AdamW gets (its own weight decay is 0.01)
    defaults = optax.adamw.__wrapped__.__defaults__ if hasattr(optax.adamw, "__wrapped__") else \
        optax.adamw.__defaults__
    b1, b2, eps, _, _, weight_decay = defaults[:6]
    assert got["optimizer"] == {"_target_": "torch.optim.AdamW", "_mode_": "partial", "lr": "@lr",
                                "weight_decay": weight_decay, "betas": [b1, b2], "eps": eps}


def test_bundle_gen_matches_jax(phantoms, tmp_path):
    items = phantoms["training"]
    params = {"roi_size": (16, 16, 16), "max_epochs": 1, "batch_size": 1}
    ref = jax_a3d.BundleGen(algos=["unet", "segresnet", "swinunetr"], data_stats_filename=STATS).generate(
        str(tmp_path / "jax"), num_fold=3, datalist=items, **params)
    got = a3d.BundleGen(algos=["unet", "segresnet", "swinunetr"], data_stats_filename=STATS,
                        device="cpu").generate(str(tmp_path / "port"), num_fold=3, datalist=items, **params)
    assert [r[AlgoKeys.ID] for r in got] == [r[JaxAlgoKeys.ID] for r in ref] == [
        f"{a}_{f}" for a in ("unet", "segresnet", "swinunetr") for f in range(3)]
    for g, r in zip(got, ref):
        cfg = json.loads((Path(g[AlgoKeys.ALGO].get_output_path()) / "configs" / "train.json").read_text())
        cfg_ref = json.loads((Path(r[JaxAlgoKeys.ALGO].get_output_path()) / "configs" / "train.json").read_text())
        assert cfg["bundle_root"] == str(tmp_path / "port" / g[AlgoKeys.ID])
        drop = DIFFERS | {"bundle_root"}
        assert {k: v for k, v in cfg.items() if k not in drop} == {k: v for k, v in cfg_ref.items() if k not in drop}
        fold = int(g[AlgoKeys.ID].split("_")[-1])
        # every fold but its own, fold after fold
        assert cfg["datalist"] == [x for i in range(3) if i != fold for x in items[i::3]]
        assert g[AlgoKeys.IS_TRAINED] is False


@pytest.mark.parametrize("seed", [0, 5])
def test_generated_bundle_crops_match_jax(phantoms, tmp_path, seed):
    items = phantoms["training"]
    params = {"roi_size": (8, 8, 8), "max_epochs": 1, "batch_size": 1}
    ref_algo = jax_a3d.BundleGen(algos=["unet"], data_stats_filename=STATS).generate(
        str(tmp_path / "jax"), num_fold=2, datalist=items, **params)[0][JaxAlgoKeys.ALGO]
    algo = a3d.BundleGen(algos=["unet"], data_stats_filename=STATS).generate(
        str(tmp_path / "port"), num_fold=2, datalist=items, **params)[0][AlgoKeys.ALGO]
    # the phantoms' 1 mm spacing for Spacingd, as the analyzer would give
    ref_parser = jax_bundle.ConfigParser()
    ref_parser.read_config(os.path.join(ref_algo.get_output_path(), "configs", "train.json"))
    ref_parser["pixdim"] = [1.0, 1.0, 1.0]
    parser = ConfigParser()
    parser.read_config(os.path.join(algo.get_output_path(), "configs", "train.json"))
    parser["pixdim"] = [1.0, 1.0, 1.0]
    parser["train_transforms::transforms::0::device"] = "cpu"
    jax_utils.set_determinism(seed=seed)
    ref_pipe = ref_parser.get_parsed_content("train_transforms")
    utils.set_determinism(seed=seed)
    pipe = parser.get_parsed_content("train_transforms")
    item = parser.get_parsed_content("datalist")[0]
    for _ in range(2):
        ref, out = ref_pipe(dict(item)), pipe(dict(item))
        assert len(out) == len(ref) == 2  # num_samples
        for o, r in zip(out, ref):
            for key, tol in (("image", 1e-5), ("label", 0.0)):
                a, b = np.asarray(r[key].data), o[key].data.numpy()
                assert a.shape == b.shape == (1, 8, 8, 8)
                assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-12), key


def _records(keys, scores):
    return [{keys.ID: name, keys.ALGO: name, keys.SCORE: s} for name, s in scores.items()]


@pytest.mark.parametrize("scores", [
    {"unet_0": -0.9, "unet_1": -0.5, "segresnet_0": -0.7, "segresnet_1": -0.6, "swinunetr_0": -0.2},
    {"unet_0": 1.0, "segresnet_0": 3.0, "swinunetr_1": 2.0, "unet_2": -1.0, "named": 5.0},
])
def test_ensembles_pick_the_jax_members(scores):
    for n_best in (1, 2, 3, 10):
        ref, got = jax_a3d.AlgoEnsembleBestN(n_best), a3d.AlgoEnsembleBestN(n_best)
        ref.set_algos(_records(JaxAlgoKeys, scores))
        got.set_algos(_records(AlgoKeys, scores))
        assert [a[AlgoKeys.ID] for a in got.collect_algos()] == [a[JaxAlgoKeys.ID] for a in ref.collect_algos()]
    for n_fold in (1, 2, 3):
        ref, got = jax_a3d.AlgoEnsembleBestByFold(n_fold), a3d.AlgoEnsembleBestByFold(n_fold)
        ref.set_algos(_records(JaxAlgoKeys, scores))
        got.set_algos(_records(AlgoKeys, scores))
        assert [a[AlgoKeys.ID] for a in got.collect_algos()] == [a[JaxAlgoKeys.ID] for a in ref.collect_algos()]
    builder = a3d.EnsembleBuilder([{AlgoKeys.ID: k, AlgoKeys.ALGO: type("A", (), {"best_metric": v})()}
                                   for k, v in scores.items()])
    assert [a[AlgoKeys.SCORE] for a in builder.get_ensemble().algos] == list(scores.values())
    assert a3d.AlgoEnsembleBuilder is a3d.EnsembleBuilder


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5], [[1.0, 0.2], [2.0, 1.0], [0.5, 3.0]]])
def test_mean_ensemble_matches_jax(weights):
    rs = np.random.RandomState(1)
    preds = [rs.rand(2, 5, 6, 4).astype(np.float32) for _ in range(3)]
    ref = jax_transforms.MeanEnsemble(weights)(preds)
    got = transforms.MeanEnsemble(weights)([torch.from_numpy(p) for p in preds])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    d = {f"p{i}": torch.from_numpy(p) for i, p in enumerate(preds)}
    ref_d = jax_transforms.MeanEnsembled(keys=list(d), output_key="out", weights=weights)(
        {k: v.numpy() for k, v in d.items()})
    got_d = transforms.MeanEnsembled(keys=list(d), output_key="out", weights=weights)(d)
    np.testing.assert_allclose(got_d["out"].numpy(), np.asarray(ref_d["out"]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_classes", [None, 3])
def test_vote_ensemble_matches_jax(num_classes):
    rs = np.random.RandomState(2)
    if num_classes is None:  # one-hot or binary members
        preds = [(rs.rand(2, 5, 6) > 0.5).astype(np.float32) for _ in range(5)]
    else:  # one-channel label maps
        preds = [rs.randint(0, num_classes, (1, 5, 6)).astype(np.float32) for _ in range(5)]
    ref = jax_transforms.VoteEnsemble(num_classes)(preds)
    got = transforms.VoteEnsemble(num_classes)([torch.from_numpy(p) for p in preds])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    d = {f"p{i}": torch.from_numpy(p) for i, p in enumerate(preds)}
    ref_d = jax_transforms.VoteEnsembled(keys=list(d), num_classes=num_classes)({k: v.numpy() for k, v in d.items()})
    got_d = transforms.VoteEnsembled(keys=list(d), num_classes=num_classes)(d)
    np.testing.assert_allclose(got_d["p0"].numpy(), np.asarray(ref_d["p0"]), atol=1e-6)


def test_auto_runner_run_json_on_cpu(tmp_path):
    """run.json through the port's runner, as README gives its CPU overrides."""
    cfg = json.loads(RUN_JSON.read_text())
    overrides = {"bundle_root": str(tmp_path),
                 "imports": [re.sub(r"\bmonai_tpu\b", "monai_tpu_torch", i) for i in cfg["imports"]],
                 "initialize": [re.sub(r"\bmonai_tpu\b", "monai_tpu_torch", i) for i in cfg["initialize"]],
                 "synth_datalist": cfg["synth_datalist"].replace("(64, 64, 64)", "(24, 24, 24)"),
                 "num_synth_images": 4, "algos": ["unet"], "runner::device": "cpu",
                 "training_params": {"roi_size": [16, 16, 16], "max_epochs": 1, "batch_size": 1}}
    ensemble = run(config_file=str(RUN_JSON), **overrides)[0]
    work = tmp_path / "work_dir"
    assert isinstance(ensemble, a3d.AlgoEnsembleBestByFold)
    stats = json.loads((work / "datastats.json").read_text())
    assert stats["n_cases"] == 3 and stats["stats_summary"]["label_stats"]["n_classes"] == 2
    members = ensemble.collect_algos()
    assert [m[AlgoKeys.ID] for m in members] == ["unet_0", "unet_1"]
    for m in members:
        out = work / m[AlgoKeys.ID]
        score = json.loads((out / "result.json").read_text())["best_metric"]
        assert np.isfinite(score) and score == m[AlgoKeys.SCORE]
        state = torch.load(out / "model" / "model_final.pt", weights_only=True)["model"]
        assert state.keys() == m[AlgoKeys.ALGO]._network().state_dict().keys()
    image = str(tmp_path / "data" / "Auto3dSegCT_synth" / "imagesTr" / "img003.nii.gz")
    pred = ensemble({"infer_files": [image]})[0]
    assert pred.shape == (1, 2, 24, 24, 24) and bool(torch.isfinite(pred).all())

    # the history on disk, and the ensemble stage on its own from it
    history = [{**m, AlgoKeys.IS_TRAINED: True} for m in ensemble.algos]
    a3d.export_bundle_algo_history(history)
    back = a3d.import_bundle_algo_history(str(work))
    assert [h[AlgoKeys.ID] for h in back] == ["unet_0", "unet_1"] and all(h[AlgoKeys.IS_TRAINED] for h in back)
    assert a3d.get_name_from_algo_id("unet_1") == "unet"
    again = a3d.EnsembleRunner(work_dir=str(work)).run(num_fold=2, pred_param={"infer_files": [image]})[0]
    torch.testing.assert_close(again, pred, rtol=0, atol=1e-6)


def test_auto_runner_refuses_hpo(tmp_path):
    """The search is no longer refused: run.json with ``runner::hpo`` (the CPU overrides of
    test_auto_runner_run_json_on_cpu) trains each bundle at the default grid's two
    learning rates, writes both trials to its ``hpo_trials.json``, and trains it again at
    the better one; a bundle with its network loaded deep-copies without it; ``set_hpo_params``
    sets the grid."""
    cfg = json.loads(RUN_JSON.read_text())
    overrides = {"bundle_root": str(tmp_path),
                 "imports": [re.sub(r"\bmonai_tpu\b", "monai_tpu_torch", i) for i in cfg["imports"]],
                 "initialize": [re.sub(r"\bmonai_tpu\b", "monai_tpu_torch", i) for i in cfg["initialize"]],
                 "synth_datalist": cfg["synth_datalist"].replace("(64, 64, 64)", "(24, 24, 24)"),
                 "num_synth_images": 4, "algos": ["unet"], "runner::device": "cpu", "runner::hpo": True,
                 "training_params": {"roi_size": [16, 16, 16], "max_epochs": 1, "batch_size": 1}}
    ensemble = run(config_file=str(RUN_JSON), **overrides)[0]
    for record in ensemble.algos:
        out = Path(record[AlgoKeys.ALGO].get_output_path())
        trials = json.loads((out / "hpo_trials.json").read_text())
        assert [t["params"] for t in trials] == [{"lr": 1e-3}, {"lr": 1e-4}]
        assert all(np.isfinite(t["score"]) for t in trials)
        assert record[AlgoKeys.SCORE] == json.loads((out / "result.json").read_text())["best_metric"]
        net = record[AlgoKeys.ALGO]._network()  # the checkpoint loaded into the algo
        assert record[AlgoKeys.ALGO]._trained_network is net
        assert not hasattr(copy.deepcopy(record[AlgoKeys.ALGO]), "_trained_network")
    runner = a3d.AutoRunner(work_dir=str(tmp_path / "w"), input={}, hpo=True, device="cpu")
    assert runner.set_hpo_params({"lr": [1e-3]}) is runner and runner.hpo_params == {"lr": [1e-3]}


def test_port_sources_import_no_jax():
    """No import line of the port's modules, nor of chip_smoke.py, names jax, flax or
    monai_tpu (a static check of the files, beside test_torch_package's import check)."""
    pattern = re.compile(r"^\s*(?:from\s+(jax|flax|monai_tpu)(?:\.|\s)|import\s+(jax|flax|monai_tpu)(?:\.|\s|,|$))",
                         re.M)
    files = sorted((REPO / "monai_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert len(files) > 100 and not bad, bad


@pytest.mark.parametrize("memory", [torch.contiguous_format, torch.channels_last_3d])
def test_group_norm_on_cpu_holds_a_nearly_constant_group(memory):
    torch.manual_seed(0)
    norm = Norm["group", 3](num_features=16, num_groups=8)
    x = torch.full((1, 16, 32, 32, 32), 0.7) + 0.3 * torch.randn(1, 16, 1, 1, 1)
    x = x + (torch.rand(1, 1, 32, 32, 32) < 0.02) * torch.randn(1, 16, 32, 32, 32) * 0.05
    with torch.no_grad():
        ref = copy.deepcopy(norm).double()(x.double())
        got = norm(x.contiguous(memory_format=memory))
    assert (got.double() - ref).abs().max().item() <= 1e-4 * ref.std().item()


def test_segresnet_on_a_window_of_background_matches_float64():
    from test_torch_dynunet import _float64

    torch.manual_seed(1)
    net = SegResNet(3, init_filters=8, in_channels=1, out_channels=2, blocks_down=(1, 2, 2), blocks_up=(1, 1),
                    device="cpu").eval()
    x = torch.zeros((1, 1, 32, 32, 32))
    x[..., 24:, 24:, 26:] = 1.0  # a corner of an object in a window of background, as a phantom's
    with torch.no_grad():
        got = net(x)
        with _float64():
            ref = copy.deepcopy(net).double()(x.double())
    assert (got.double() - ref).abs().max().item() <= 1e-4 * ref.std().item()
