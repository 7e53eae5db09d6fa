"""Auto3DSeg's hyperparameter search in monai_tpu_torch against monai_tpu's, on the CPU.

- ``GridHPOGen`` and ``RandomHPOGen`` (several seeds, a space of uniform ranges and
  choices) propose the JAX package's points in order, through ``get_hyperparameters``
  and through ``run``, given a stub algorithm with a known score; ``run`` picks the same
  best, trains a copy a trial (the stub's own instance is never trained), and writes the
  same ``hpo_trials.json``.
- ``AutoRunner(hpo=True)`` with ``set_hpo_params`` on four 16^3 phantoms, each package's
  ``BundleAlgo.train`` replaced by the same scoring stub (training itself is held to the
  JAX package elsewhere): each bundle's ``hpo_trials.json`` and the params of its final
  training equal the JAX runner's.
- ``NNIGen`` and ``OptunaGen`` raise ``ImportError`` without their packages, as the JAX
  package's do.
"""
import json
import math

import numpy as np
import pytest

import monai_tpu.apps.auto3dseg as jax_a3d
from monai_tpu.utils.enums import AlgoKeys as JaxAlgoKeys
from monai_tpu_torch.apps import auto3dseg as a3d
from monai_tpu_torch.data import write_nifti
from monai_tpu_torch.data.synthetic import create_test_image_3d
from monai_tpu_torch.utils import AlgoKeys
from monai_tpu_torch.utils.module import optional_import


def _score(params: dict, name: str = "") -> float:
    fold = int(name.rsplit("_", 1)[-1]) if name[-1:].isdigit() else 0
    return -abs(math.log10(params.get("lr", 1e-3)) + 3.4) - 0.05 * params.get("batch_size", 1) * (1 + fold) \
        + 0.01 * len(str(params.get("opt", "")))


class _Stub:
    """An algorithm whose score is ``_score`` of the params it was trained with."""

    def __init__(self):
        self.trained_with = []
        self.score = None

    def train(self, params):
        self.trained_with.append(dict(params))
        self.score = _score(params)

    def get_score(self):
        return self.score


GRID = {"lr": [1e-2, 1e-3, 1e-4], "batch_size": [1, 2]}
RANDOM = {"lr": (1e-4, 1e-2), "opt": ["adam", "sgd", "adamw"], "batch_size": [1, 2, 4], "momentum": (0, 1)}


def _gens(kind, seed):
    if kind == "grid":
        return a3d.GridHPOGen(_Stub(), GRID), jax_a3d.GridHPOGen(_Stub(), GRID)
    return (a3d.RandomHPOGen(_Stub(), RANDOM, n_trials=6, seed=seed),
            jax_a3d.RandomHPOGen(_Stub(), RANDOM, n_trials=6, seed=seed))


@pytest.mark.parametrize("kind,seed", [("grid", 0), ("random", 0), ("random", 7)])
def test_search_proposes_and_picks_as_jax(kind, seed, tmp_path):
    port, ref = _gens(kind, seed)
    n = 6
    assert [port.get_hyperparameters() for _ in range(n)] == [ref.get_hyperparameters() for _ in range(n)]
    port, ref = _gens(kind, seed)
    got, want = port.run(output_folder=str(tmp_path / "port")), ref.run(output_folder=str(tmp_path / "jax"))
    assert got == want and len(got[2]) == n and np.isfinite(got[1])
    assert got[1] == max(t["score"] for t in got[2]) and port.algo.trained_with == []
    assert json.loads((tmp_path / "port" / "hpo_trials.json").read_text()) == \
        json.loads((tmp_path / "jax" / "hpo_trials.json").read_text())


def _stub_train(calls):
    def train(self, train_params=None, device_setting=None):
        params = dict(train_params or {})
        calls.append((self.name, params))
        self.best_metric = _score(params, self.name)
        return {"best_metric": self.best_metric}
    return train


def test_auto_runner_search_matches_jax(tmp_path, monkeypatch):
    rs = np.random.RandomState(4)
    items = []
    for i in range(4):
        im, seg = create_test_image_3d(16, 16, 16, num_objs=3, rad_max=5, rad_min=2, random_state=rs)
        items.append({"image": str(tmp_path / f"img{i}.nii.gz"), "label": str(tmp_path / f"seg{i}.nii.gz")})
        write_nifti(im.astype(np.float32), items[-1]["image"])
        write_nifti(seg.astype(np.uint8), items[-1]["label"])
    space = {"lr": [1e-2, 1e-3, 1e-4], "batch_size": [1, 2]}
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(a3d.BundleAlgo, "train", _stub_train(calls["port"]))
    monkeypatch.setattr(jax_a3d.BundleAlgo, "train", _stub_train(calls["jax"]))
    results = {}
    for name, pkg, keys, kw in (("port", a3d, AlgoKeys, {"device": "cpu"}), ("jax", jax_a3d, JaxAlgoKeys, {})):
        runner = pkg.AutoRunner(work_dir=str(tmp_path / name), input={"datalist": {"training": items}},
                                algos=["unet", "segresnet"], hpo=True, ensemble=False, **kw)
        history = runner.set_hpo_params(space).set_training_params({"max_epochs": 1}).run()
        results[name] = [(h[keys.ID], h[keys.SCORE],
                          json.loads((tmp_path / name / h[keys.ID] / "hpo_trials.json").read_text()))
                         for h in history]
    assert results["port"] == results["jax"] and len(results["port"]) == 4
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 4 * (6 + 1)
    for bundle, _, trials in results["port"]:
        final = [p for n, p in calls["port"] if n == bundle][-1]
        best = max(trials, key=lambda t: t["score"])["params"]
        assert final == {"max_epochs": 1, **best}


def test_nni_and_optuna_gens_need_their_packages():
    for package, port_gen, jax_gen in (("nni", a3d.NNIGen, jax_a3d.NNIGen),
                                       ("optuna", a3d.OptunaGen, jax_a3d.OptunaGen)):
        if optional_import(package)[1]:
            pytest.skip(f"{package} is installed")
        for gen in (port_gen(_Stub()), jax_gen(_Stub())):
            with pytest.raises(ImportError, match=package):
                gen.get_hyperparameters() if package == "nni" else gen(trial=object())
