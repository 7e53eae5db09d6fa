"""AutoRunner (counterpart of monai_tpu/apps/auto3dseg/auto_runner.py): analyze the data,
generate one bundle a template and fold, train each in this process, and ensemble the
best of each fold. With ``hpo=True`` each bundle's training is a search first: a
``GridHPOGen`` over ``set_hpo_params``'s space (default ``{"lr": [1e-3, 1e-4]}``) trains a
copy of the bundle at each point, writes ``hpo_trials.json`` into the bundle's folder, and
the bundle is then trained with the best point's params. ``hpo_backend`` is taken for the
signature: the search is local, whatever it names."""
from __future__ import annotations

import json
import os

from ...utils.enums import AlgoKeys
from .analyzer import DataAnalyzer
from .bundle_gen import BundleGen
from .ensemble_builder import AlgoEnsembleBestByFold, AlgoEnsembleBestN, EnsembleBuilder
from .hpo_gen import GridHPOGen

__all__ = ["AutoRunner"]


class AutoRunner:
    """``input`` is ``{"datalist": a datalist dict or json file, "dataroot": a folder,
    "modality": "CT" or "MR"}`` (or a json or yaml file of it). ``device`` (None: the
    CUDA card) is where the analysis, the training and the prediction run."""

    def __init__(self, work_dir: str = "./work_dir", input: dict | str | None = None,
                 algos: list[str] | str | None = None, analyze: bool | None = None, algo_gen: bool | None = None,
                 train: bool | None = None, hpo: bool = False, hpo_backend: str = "nni", ensemble: bool = True,
                 not_use_cache: bool = False, templates_path_or_url: str | None = None, allow_skip: bool = True,
                 device=None, **kwargs):
        self.work_dir = os.path.abspath(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        if isinstance(input, str):
            with open(input) as f:
                if input.endswith(".json"):
                    input = json.load(f)
                else:
                    import yaml

                    input = yaml.safe_load(f)
        self.input_cfg: dict = input or {}
        self.algos = [algos] if isinstance(algos, str) else (algos or ["unet", "segresnet"])
        self.analyze = True if analyze is None else analyze
        self.algo_gen_flag = True if algo_gen is None else algo_gen
        self.train_flag = True if train is None else train
        self.ensemble_flag = ensemble
        self.num_fold = kwargs.get("num_fold", 2)
        self.hpo = hpo
        self.hpo_params: dict | None = None
        self.device = device
        self.train_params: dict = {}
        self.history: list[dict] = []
        self.data_stats: dict = {}
        self.datastats_filename = os.path.join(self.work_dir, "datastats.json")
        self.ensemble_method_name = "AlgoEnsembleBestByFold"

    def set_num_fold(self, num_fold: int) -> AutoRunner:
        self.num_fold = num_fold
        return self

    def set_training_params(self, params: dict) -> AutoRunner:
        self.train_params = dict(params)
        return self

    def set_hpo_params(self, params: dict) -> AutoRunner:
        """The search space of ``hpo=True``: ``{param: [values, ...]}``."""
        self.hpo_params = dict(params)
        return self

    def set_ensemble_method(self, ensemble_method_name: str = "AlgoEnsembleBestByFold", **kwargs) -> AutoRunner:
        self.ensemble_method_name = ensemble_method_name
        return self

    def _load_datalist(self) -> list[dict]:
        datalist = self.input_cfg.get("datalist")
        dataroot = self.input_cfg.get("dataroot", "")
        if isinstance(datalist, str):
            with open(datalist) as f:
                datalist = json.load(f)
        out = []
        for item in datalist.get("training", []):
            entry = dict(item) if isinstance(item, dict) else {"image": item}
            for k, v in entry.items():
                if isinstance(v, str) and dataroot and not os.path.isabs(v):
                    entry[k] = os.path.join(dataroot, v)
            out.append(entry)
        return out

    def run(self):
        """Analyze, generate, train each bundle, ensemble; returns the ensemble (the
        history where ``ensemble`` is off)."""
        if self.analyze:
            analyzer = DataAnalyzer(self.input_cfg.get("datalist"), self.input_cfg.get("dataroot", ""),
                                    output_path=self.datastats_filename, fmt="json", device=self.device)
            self.data_stats = analyzer.get_all_case_stats()
        elif os.path.exists(self.datastats_filename):
            with open(self.datastats_filename) as f:
                self.data_stats = json.load(f)

        datalist = self._load_datalist()
        if self.algo_gen_flag:
            gen = BundleGen(algo_path=self.work_dir, algos=self.algos,
                            data_stats_filename=self.data_stats or self.datastats_filename, device=self.device)
            template_params = {k: v for k, v in self.train_params.items()
                               if k in ("roi_size", "max_epochs", "lr", "batch_size")}
            self.history = gen.generate(self.work_dir, num_fold=self.num_fold, datalist=datalist, **template_params)

        if self.train_flag:
            overrides = {k: v for k, v in self.train_params.items() if k in ("max_epochs", "lr", "batch_size")}
            for record in self.history:
                algo = record[AlgoKeys.ALGO]
                if self.hpo:
                    search = GridHPOGen(algo=algo, search_space=self.hpo_params or {"lr": [1e-3, 1e-4]})
                    best_params, _, _ = search.run(output_folder=algo.get_output_path() or self.work_dir)
                    algo.train({**overrides, **best_params})
                else:
                    algo.train(overrides)
                record[AlgoKeys.IS_TRAINED] = True
                record[AlgoKeys.SCORE] = algo.get_score()

        if self.ensemble_flag and self.history:
            builder = EnsembleBuilder(self.history)
            if self.ensemble_method_name == "AlgoEnsembleBestN":
                builder.set_ensemble_method(AlgoEnsembleBestN())
            else:
                builder.set_ensemble_method(AlgoEnsembleBestByFold(n_fold=self.num_fold))
            self.ensemble = builder.get_ensemble()
            return self.ensemble
        return self.history
