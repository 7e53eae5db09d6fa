"""Auto3DSeg's history on disk (counterpart of monai_tpu/apps/auto3dseg/utils.py): each
algorithm pickled into its folder with its score, and the history read back from those
pickles."""
from __future__ import annotations

import os
import pickle

from ...utils.enums import AlgoKeys

__all__ = ["algo_to_pickle", "algo_from_pickle", "export_bundle_algo_history", "import_bundle_algo_history",
           "get_name_from_algo_id"]

_PKL_NAME = "algo_object.pkl"


def algo_to_pickle(algo, template_path: str | None = None, **algo_meta_data) -> str:
    """Pickle ``algo`` and ``algo_meta_data`` into ``<its output path>/algo_object.pkl``;
    returns the file's path."""
    out = algo.get_output_path()
    os.makedirs(out, exist_ok=True)
    pkl_filename = os.path.join(out, _PKL_NAME)
    data = {"algo_bytes": pickle.dumps(algo), "template_path": template_path, **algo_meta_data}
    with open(pkl_filename, "wb") as f:
        pickle.dump(data, f)
    return pkl_filename


def algo_from_pickle(pkl_filename: str, template_path: str | None = None):
    """The algo of ``algo_to_pickle``'s file, and its metadata dict."""
    with open(pkl_filename, "rb") as f:
        data = pickle.load(f)
    return pickle.loads(data.pop("algo_bytes")), data


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
