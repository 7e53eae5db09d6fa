"""The Auto3DSeg algorithm interfaces (counterpart of ``Algo`` and ``AlgoGen`` in
monai_tpu/apps/auto3dseg/algo_gen.py). The JAX package's in-code trainer ``SegAlgo``,
which no path of the runner calls, is not ported (ROADMAP A7)."""
from __future__ import annotations

__all__ = ["Algo", "AlgoGen"]


class Algo:
    """An algorithm's lifecycle: data statistics, training, its score, its inferer and
    prediction."""

    def set_data_stats(self, *args, **kwargs):
        pass

    def train(self, *args, **kwargs):
        raise NotImplementedError

    def get_score(self, *args, **kwargs):
        raise NotImplementedError

    def get_inferer(self, *args, **kwargs):
        raise NotImplementedError

    def get_output_path(self, *args, **kwargs):
        raise NotImplementedError

    def predict(self, *args, **kwargs):
        raise NotImplementedError


class AlgoGen(Algo):
    """An algorithm generator: a data source, then algorithms generated from it."""

    def set_data_source(self, *args, **kwargs):
        pass

    def generate(self, *args, **kwargs):
        pass

    def run_algo(self, *args, **kwargs):
        pass
