"""The Auto3DSeg algorithm interfaces (counterpart of monai_tpu/auto3dseg/algo_gen.py):
``Algo``, an algorithm's lifecycle, and ``AlgoGen``, a generator of algorithms. One
``Algo`` serves both this package and ``apps.auto3dseg``; each method does nothing until a
subclass gives it a body."""
from __future__ import annotations

from typing import Any

from ..transforms.transform import Randomizable

__all__ = ["Algo", "AlgoGen"]


class Algo:
    """An algorithm's lifecycle: data statistics, training, prediction, its score, its
    inferer and its output folder."""

    def set_data_stats(self, *args: Any, **kwargs: Any) -> None:
        pass

    def train(self, *args: Any, **kwargs: Any):
        pass

    def predict(self, *args: Any, **kwargs: Any):
        pass

    def get_score(self, *args: Any, **kwargs: Any):
        pass

    def get_inferer(self, *args: Any, **kwargs: Any):
        pass

    def get_output_path(self, *args: Any, **kwargs: Any):
        pass


class AlgoGen(Randomizable):
    """A generator of algorithms from a data source and its statistics, within a budget,
    told each algorithm's score."""

    def set_data_stats(self, *args: Any, **kwargs: Any) -> None:
        pass

    def set_data_source(self, *args: Any, **kwargs: Any) -> None:
        pass

    def set_budget(self, *args: Any, **kwargs: Any) -> None:
        pass

    def set_score(self, *args: Any, **kwargs: Any) -> None:
        pass

    def get_data_stats(self, *args: Any, **kwargs: Any):
        pass

    def get_budget(self, *args: Any, **kwargs: Any):
        pass

    def get_history(self, *args: Any, **kwargs: Any):
        pass

    def generate(self, *args: Any, **kwargs: Any):
        pass

    def run_algo(self, *args: Any, **kwargs: Any):
        pass
