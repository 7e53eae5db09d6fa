"""Hyperparameter search over an Auto3DSeg algorithm (counterpart of
monai_tpu/apps/auto3dseg/hpo_gen.py): ``HPOGen``'s protocol (propose params, train the
algorithm with them, report its score), the local searches ``GridHPOGen`` (every point of a
grid, in order) and ``RandomHPOGen`` (points drawn from a numpy ``RandomState(seed)`` in
the JAX package's order, so both propose the same points), and ``NNIGen`` and
``OptunaGen``, which need the ``nni`` and ``optuna`` packages and raise ``ImportError``
without them, as the JAX package's do.

Each trial trains a deep copy of the algorithm (a ``BundleAlgo``'s copy holds no network:
its pickled state drops the trained one), so trials share no weights.
"""
from __future__ import annotations

import itertools
import json
import os
from copy import deepcopy
from typing import Sequence

import numpy as np

from ...auto3dseg.algo_gen import Algo, AlgoGen
from ...utils.module import optional_import

__all__ = ["HPOGen", "NNIGen", "GridHPOGen", "RandomHPOGen", "OptunaGen"]


class HPOGen(AlgoGen):
    """A search's protocol: ``get_hyperparameters`` proposes, ``update_params`` sets the
    params, ``run_algo`` trains the algorithm with them and reports its score through
    ``set_score``."""

    def __init__(self, algo: Algo | None = None, params: dict | None = None):
        self.algo = algo
        self.params = params or {}
        self.obj_filename: str | None = None

    def get_hyperparameters(self) -> dict:
        raise NotImplementedError

    def update_params(self, params: dict) -> None:
        self.params = dict(params)

    def set_score(self, acc) -> None:
        raise NotImplementedError

    def run_algo(self, obj_filename: str | None = None, output_folder: str = ".",
                 template_path: str | None = None) -> float:
        """One trial: train the algorithm with the current params; report and return its
        score."""
        algo = self.algo
        if algo is None:
            raise ValueError("no algo attached to this HPO generator.")
        algo.train(self.params)
        score = float(algo.get_score())
        try:
            self.set_score(score)
        except NotImplementedError:
            pass
        return score


class NNIGen(HPOGen):
    """A search driven by NNI (``nni.get_next_parameter``, ``nni.report_final_result``);
    needs the ``nni`` package."""

    def __init__(self, algo: Algo | None = None, params: dict | None = None):
        super().__init__(algo, params)
        self._nni, self._has_nni = optional_import("nni")

    def get_hyperparameters(self) -> dict:
        if not self._has_nni:
            raise ImportError("NNIGen requires the 'nni' package, which is not installed; "
                              "use GridHPOGen/RandomHPOGen for hermetic local search.")
        return self._nni.get_next_parameter()

    def set_score(self, acc) -> None:
        if not self._has_nni:
            raise ImportError("NNIGen requires the 'nni' package.")
        self._nni.report_final_result(acc)

    def get_obj_filename(self) -> str | None:
        return self.obj_filename


class GridHPOGen(HPOGen):
    """Every point of ``search_space`` (``{param: [values, ...]}``, the product in key
    order), one trial each. ``run`` returns (best params, best score, trials) and writes
    the trials to ``<output_folder>/hpo_trials.json``."""

    def __init__(self, algo: Algo | None = None, search_space: dict[str, Sequence] | None = None):
        super().__init__(algo)
        self.search_space = {k: list(v) for k, v in (search_space or {}).items()}
        self.trials: list[dict] = []
        self._proposals = None
        self._last_score: float | None = None

    def _grid(self):
        keys = list(self.search_space)
        for combo in itertools.product(*(self.search_space[k] for k in keys)):
            yield dict(zip(keys, combo))

    def get_hyperparameters(self) -> dict:
        if self._proposals is None:
            self._proposals = iter(self._grid())
        return next(self._proposals)

    def set_score(self, acc) -> None:
        self._last_score = float(acc)

    def run(self, output_folder: str | None = None) -> tuple[dict, float, list[dict]]:
        best_params, best_score = {}, -np.inf
        for params in self._grid():
            saved = self.algo
            self.params, self.algo = params, deepcopy(saved)
            try:
                score = self.run_algo()
            finally:
                self.algo = saved
            self.trials.append({"params": params, "score": score})
            if score > best_score:
                best_params, best_score = params, score
        if output_folder:
            os.makedirs(output_folder, exist_ok=True)
            with open(os.path.join(output_folder, "hpo_trials.json"), "w") as f:
                json.dump(self.trials, f, indent=2, default=str)
        return best_params, best_score, self.trials


class RandomHPOGen(GridHPOGen):
    """``n_trials`` points drawn from ``search_space``: a (low, high) tuple of numbers is
    drawn uniformly, anything else is a list of choices; each point's values drawn in the
    space's key order from ``RandomState(seed)``."""

    def __init__(self, algo: Algo | None = None, search_space: dict | None = None, n_trials: int = 4,
                 seed: int = 0):
        HPOGen.__init__(self, algo)
        self.search_space = dict(search_space or {})
        self.n_trials = n_trials
        self.rng = np.random.RandomState(seed)
        self.trials = []
        self._proposals = None
        self._last_score = None

    def _grid(self):
        for _ in range(self.n_trials):
            point = {}
            for k, v in self.search_space.items():
                if isinstance(v, tuple) and len(v) == 2 and all(isinstance(x, (int, float)) for x in v):
                    point[k] = float(self.rng.uniform(v[0], v[1]))
                else:
                    point[k] = v[self.rng.randint(len(v))]
            yield point


class OptunaGen(HPOGen):
    """A search driven by Optuna: the generator is the objective of
    ``optuna.Study.optimize``; needs the ``optuna`` package."""

    def __init__(self, algo: Algo | None = None, params: dict | None = None):
        super().__init__(algo, params)
        self._optuna, self._has_optuna = optional_import("optuna")
        self.trial = None

    def get_hyperparameters(self) -> dict:
        if self.trial is None:
            raise RuntimeError("OptunaGen must be called by optuna: study.optimize(OptunaGen(...))")
        return dict(self.params)

    def set_score(self, acc) -> None:
        self._score = float(acc)

    def set_trial(self, trial) -> None:
        self.trial = trial

    def __call__(self, trial, obj_filename: str | None = None, output_folder: str = ".",
                 template_path=None) -> float:
        if not self._has_optuna:
            raise ImportError("OptunaGen requires the 'optuna' package, which is not installed.")
        self.set_trial(trial)
        return self.run_algo(obj_filename, output_folder, template_path)
