"""Auto3DSeg's history on disk (counterpart of monai_tpu/apps/auto3dseg/utils.py): each
algorithm pickled into its folder with its score (``auto3dseg.utils.algo_to_pickle``), and
the history read back from those pickles."""
from __future__ import annotations

import os

from ...auto3dseg.utils import algo_from_pickle, algo_to_pickle
from ...utils.enums import AlgoKeys

__all__ = ["algo_to_pickle", "algo_from_pickle", "export_bundle_algo_history", "import_bundle_algo_history",
           "get_name_from_algo_id"]

_PKL_NAME = "algo_object.pkl"


def export_bundle_algo_history(history: list[dict]) -> None:
    """Pickle every algo of a ``BundleGen`` history into its folder, with its score where
    the record has one."""
    for algo_dict in history:
        algo = algo_dict[AlgoKeys.ALGO]
        score = algo_dict.get(AlgoKeys.SCORE)
        meta = {} if score is None else {AlgoKeys.SCORE: score}
        algo_to_pickle(algo, template_path=getattr(algo, "template_path", None), **meta)


def import_bundle_algo_history(output_folder: str = ".", template_path: str | None = None,
                               only_trained: bool = True) -> list:
    """The history from the pickles in the folders of ``output_folder``, in name order: a
    record is trained where it has a score (from the pickle, else ``get_score``)."""
    history = []
    for name in sorted(os.listdir(output_folder)):
        pkl = os.path.join(output_folder, name, _PKL_NAME)
        if not os.path.isfile(pkl):
            continue
        algo, meta = algo_from_pickle(pkl, template_path=template_path)
        best_metric = meta.get(AlgoKeys.SCORE)
        if best_metric is None:
            try:
                best_metric = algo.get_score()
            except Exception:
                pass
        is_trained = best_metric is not None
        if is_trained or not only_trained:
            history.append({AlgoKeys.ID: name, AlgoKeys.ALGO: algo, AlgoKeys.SCORE: best_metric,
                            AlgoKeys.IS_TRAINED: is_trained})
    return history


def get_name_from_algo_id(id: str) -> str:
    """``"<algo name>_<fold>"`` to the algo's name."""
    return id.split("_")[0]
