"""Auto3DSeg's ensembles (counterpart of monai_tpu/apps/auto3dseg/ensemble_builder.py):
the trained algorithms chosen by score (the best N, or the best of each fold), their
predictions of each file and the mean (or vote) over them."""
from __future__ import annotations

import json
import os
from abc import ABC, abstractmethod
from copy import deepcopy

import numpy as np

from ...transforms.post_array import MeanEnsemble, VoteEnsemble
from ...utils.enums import AlgoKeys

__all__ = ["AlgoEnsemble", "AlgoEnsembleBestN", "AlgoEnsembleBestByFold", "AlgoEnsembleBuilder", "EnsembleBuilder",
           "EnsembleRunner"]


class AlgoEnsemble(ABC):
    """Trained algorithms (records of ``AlgoKeys``) and the files to predict; calling it
    gives each file's ensembled prediction."""

    def __init__(self):
        self.algos: list[dict] = []
        self.mode = "mean"
        self.infer_files: list = []

    def set_algos(self, infer_algos: list[dict]) -> None:
        self.algos = deepcopy(infer_algos)

    def get_algo(self, identifier: str):
        return next((algo for algo in self.algos if identifier == algo[AlgoKeys.ID]), None)

    def get_algo_ensemble(self) -> list:
        return self.algos

    def set_infer_files(self, dataroot: str, data_list_or_path, data_key: str = "testing") -> None:
        """The files to predict: a list as it is, else the ``data_key`` items of a datalist
        file, relative paths under ``dataroot``."""
        if isinstance(data_list_or_path, list):
            self.infer_files = data_list_or_path
            return
        with open(data_list_or_path) as f:
            datalist = json.load(f)
        out = []
        for f_item in datalist.get(data_key, []):
            item = dict(f_item) if isinstance(f_item, dict) else {"image": f_item}
            for k, v in item.items():
                if isinstance(v, str) and not os.path.isabs(v):
                    item[k] = os.path.join(dataroot, v)
            out.append(item)
        self.infer_files = out

    def ensemble_pred(self, preds: list, sigmoid: bool = False):
        """The mean of the members' predictions (``mode`` "mean"), else their vote."""
        if self.mode == "mean":
            return MeanEnsemble()(preds)
        return VoteEnsemble(num_classes=None)(preds)

    def __call__(self, pred_param: dict | None = None) -> list:
        """Each file's ensembled prediction; ``pred_param`` may give ``infer_files`` and
        ``sigmoid``."""
        param = pred_param or {}
        files = param.pop("infer_files", self.infer_files)
        sigmoid = param.pop("sigmoid", False)
        outputs = []
        for file in files:
            preds = []
            for algo in self.collect_algos():
                preds.extend(algo[AlgoKeys.ALGO].predict({"files": [file["image"] if isinstance(file, dict) else file]}))
            outputs.append(self.ensemble_pred(preds, sigmoid=sigmoid))
        return outputs

    @abstractmethod
    def collect_algos(self) -> list:
        raise NotImplementedError


class AlgoEnsembleBestN(AlgoEnsemble):
    """The ``n_best`` algorithms of the highest scores."""

    def __init__(self, n_best: int = 5):
        super().__init__()
        self.n_best = n_best

    def sort_score(self) -> list:
        return np.argsort([a.get(AlgoKeys.SCORE, -np.inf) for a in self.algos]).tolist()

    def collect_algos(self, n_best: int = -1) -> list:
        if n_best <= 0:
            n_best = self.n_best
        ranks = self.sort_score()
        keep = set(ranks[-min(n_best, len(ranks)):])
        return [a for i, a in enumerate(self.algos) if i in keep]


class AlgoEnsembleBestByFold(AlgoEnsemble):
    """The algorithm of the highest score of each of ``n_fold`` folds (an id's last
    ``_``-separated part is its fold)."""

    def __init__(self, n_fold: int = 5):
        super().__init__()
        self.n_fold = n_fold

    def collect_algos(self) -> list:
        best_per_fold = []
        for f_idx in range(self.n_fold):
            best_score, best_model = -np.inf, None
            for algo in self.algos:
                try:
                    algo_id = int(algo[AlgoKeys.ID].split("_")[-1])
                except ValueError:
                    continue
                if algo_id == f_idx and algo.get(AlgoKeys.SCORE, -np.inf) > best_score:
                    best_model, best_score = algo, algo[AlgoKeys.SCORE]
            if best_model is not None:
                best_per_fold.append(best_model)
        return best_per_fold


class EnsembleBuilder:
    """An ensemble of a history's algorithms, each with its score."""

    def __init__(self, history: list[dict], data_src_cfg_name: str | None = None):
        self.infer_algos: list[dict] = []
        self.ensemble: AlgoEnsemble | None = None
        for algo_dict in history:
            gen_algo = algo_dict[AlgoKeys.ALGO]
            best_metric = getattr(gen_algo, "best_metric", None)
            if best_metric is None:
                try:
                    best_metric = gen_algo.get_score()
                except Exception:
                    best_metric = -np.inf
            self.add_inferer(algo_dict[AlgoKeys.ID], gen_algo, best_metric)

    def add_inferer(self, identifier: str, gen_algo, best_metric: float | None = None) -> None:
        self.infer_algos.append({AlgoKeys.ID: identifier, AlgoKeys.ALGO: gen_algo, AlgoKeys.SCORE: best_metric})

    def set_ensemble_method(self, ensemble: AlgoEnsemble, *args, **kwargs) -> None:
        ensemble.set_algos(self.infer_algos)
        self.ensemble = ensemble

    def get_ensemble(self) -> AlgoEnsemble:
        if self.ensemble is None:
            self.set_ensemble_method(AlgoEnsembleBestN())
        return self.ensemble


AlgoEnsembleBuilder = EnsembleBuilder  # torch MONAI's name


class EnsembleRunner:
    """The ensemble stage on its own: the history (read from ``work_dir``'s pickles where
    none is given), the ensemble method, the prediction of the files to predict."""

    def __init__(self, data_src_cfg_name: str | None = None, work_dir: str = "./work_dir", indices=None,
                 ensemble_method_name: str = "AlgoEnsembleBestByFold", mgpu: bool = False, **kwargs):
        self.data_src_cfg_name = data_src_cfg_name
        self.work_dir = work_dir
        self.indices = indices
        self.ensemble_method_name = ensemble_method_name
        self.kwargs = dict(kwargs)
        self.ensemble: AlgoEnsemble | None = None

    def set_ensemble_method(self, ensemble_method_name: str = "AlgoEnsembleBestByFold", **kwargs) -> None:
        self.ensemble_method_name = ensemble_method_name
        self.kwargs.update(kwargs)

    def _make_method(self, num_fold: int = 1) -> AlgoEnsemble:
        if self.ensemble_method_name == "AlgoEnsembleBestN":
            return AlgoEnsembleBestN(n_best=self.kwargs.get("n_best", 2))
        if self.ensemble_method_name == "AlgoEnsembleBestByFold":
            return AlgoEnsembleBestByFold(n_fold=num_fold)
        raise ValueError(f"Unsupported ensemble method {self.ensemble_method_name}.")

    def run(self, history: list[dict] | None = None, num_fold: int = 1, pred_param: dict | None = None) -> list:
        """Build the ensemble and predict; each file's ensembled prediction."""
        if history is None:
            from .utils import import_bundle_algo_history

            history = import_bundle_algo_history(self.work_dir, only_trained=True)
        builder = EnsembleBuilder(history, self.data_src_cfg_name)
        builder.set_ensemble_method(self._make_method(num_fold))
        self.ensemble = builder.get_ensemble()
        if self.data_src_cfg_name and not self.ensemble.infer_files:
            with open(self.data_src_cfg_name) as f:
                src = json.load(f)
            self.ensemble.set_infer_files(src.get("dataroot", ""), src.get("datalist", {}))
        return self.ensemble(pred_param or {})
