"""Auto3DSeg's engine utilities (counterpart of monai_tpu/auto3dseg/utils.py): an image's
foreground, a mask's connected components, values gathered from a list of reports, a
datalist's folds, a report's format, an algorithm pickled with its template path, and
python-fire argument strings."""
from __future__ import annotations

import os
import pickle
import sys
from copy import deepcopy
from typing import Any

import numpy as np
import torch

from ..bundle.config_parser import ConfigParser
from ..bundle.utils import ID_SEP_KEY

__all__ = [
    "get_foreground_image", "get_foreground_label", "get_label_ccp",
    "concat_val_to_np", "concat_multikeys_to_dict", "datafold_read",
    "verify_report_format", "algo_to_pickle", "algo_from_pickle",
    "list_to_python_fire_arg_str", "check_and_set_optional_args",
]


def _values(x) -> torch.Tensor | np.ndarray:
    """A MetaImage's tensor, a tensor or an array as it is."""
    return x if isinstance(x, np.ndarray) else getattr(x, "data", x)


def get_foreground_image(image):
    """``image`` cropped to the bounding box of its positive voxels."""
    from ..transforms.croppad_array import CropForeground

    cropper = CropForeground(select_fn=lambda x: x > 0, allow_smaller=True)
    return cropper(image)


def get_foreground_label(image, label):
    """The values of ``image`` where ``label`` > 0, flattened, where the image lies."""
    img, lab = _values(image), _values(label)
    return img[lab > 0]


def get_label_ccp(mask_index, use_gpu: bool = True) -> tuple[list, int]:
    """The connected components of a mask's positive voxels (scipy's ``ndimage.label`` on
    the host, as the JAX package) and each one's bounding-box shape; ``use_gpu`` is taken
    for the signature and changes nothing."""
    from scipy import ndimage as ndi

    arr = _values(mask_index)
    arr = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    labeled, ncomponents = ndi.label(arr > 0)
    shape_list = []
    for ncomp in range(1, ncomponents + 1):
        comp_idx = np.argwhere(labeled == ncomp)
        lo, hi = np.min(comp_idx, axis=0).tolist(), np.max(comp_idx, axis=0).tolist()
        shape_list.append([hi[i] - lo[i] + 1 for i in range(len(hi))])
    return shape_list, ncomponents


def concat_val_to_np(data_list: list, fixed_keys: list, ragged: bool | None = False,
                     allow_missing: bool | None = False, **kwargs: Any) -> np.ndarray:
    """The value at the key path ``fixed_keys`` of each dict of ``data_list``, concatenated
    (stacked where not ``ragged``) into one array."""
    np_list: list = []
    for data in data_list:
        val = ConfigParser(data).get(ID_SEP_KEY.join(str(k) for k in fixed_keys))
        if val is None:
            if not allow_missing:
                raise AttributeError(f"{fixed_keys} is not nested in the dictionary")
            np_list.append(None)
        elif isinstance(val, (list, tuple)):
            np_list.append(np.array(val))
        elif isinstance(val, np.ndarray):
            np_list.append(val)
        elif isinstance(val, torch.Tensor) or hasattr(val, "shape"):
            np_list.append(np.asarray(torch.as_tensor(_values(val)).detach().cpu().numpy()))
        elif isinstance(val, (int, float)):
            np_list.append(np.array(val))
        else:
            raise NotImplementedError(f"{val.__class__} concat is not supported.")
    if allow_missing:
        np_list = [x for x in np_list if x is not None]
    if len(np_list) == 0:
        return np.array([0])
    if ragged:
        return np.concatenate(np_list, **kwargs)
    return np.concatenate([np_list], **kwargs)


def concat_multikeys_to_dict(data_list: list, fixed_keys: list, keys: list, zero_insert: bool = True,
                             **kwargs: Any) -> dict:
    """``concat_val_to_np`` for each leaf key of ``keys`` under ``fixed_keys`` (and index 0
    before it where ``zero_insert``)."""
    ret_dict = {}
    for key in keys:
        addon = [0, key] if zero_insert else [key]
        ret_dict[key] = concat_val_to_np(data_list, list(fixed_keys) + addon, **kwargs)
    return ret_dict


def datafold_read(datalist, basedir: str, fold: int = 0, key: str = "training") -> tuple[list, list]:
    """A decathlon datalist's ``key`` items (paths joined to ``basedir``) split into those
    of the other folds and those whose ``fold`` is ``fold``: (train, val)."""
    json_data = ConfigParser.load_config_file(datalist) if isinstance(datalist, str) else datalist
    dict_data = deepcopy(json_data[key])
    for d in dict_data:
        for k in d:
            if isinstance(d[k], list):
                d[k] = [os.path.join(basedir, iv) for iv in d[k]]
            elif isinstance(d[k], str):
                d[k] = os.path.join(basedir, d[k]) if len(d[k]) > 0 else d[k]
    tr, val = [], []
    for d in dict_data:
        (val if "fold" in d and d["fold"] == fold else tr).append(d)
    return tr, val


def verify_report_format(report: dict, report_format: dict) -> bool:
    """Whether ``report`` has every key of ``report_format``, a list's first item checked
    against the format's single item."""
    for k_fmt, v_fmt in report_format.items():
        if k_fmt not in report:
            return False
        v = report[k_fmt]
        if isinstance(v_fmt, list) and isinstance(v, list):
            if len(v_fmt) != 1:
                raise UserWarning("list length in report_format is not 1")
            if len(v_fmt) > 0 and len(v) > 0:
                return verify_report_format(v[0], v_fmt[0])
            return False
    return True


def algo_to_pickle(algo, template_path=None, **algo_meta_data: Any) -> str:
    """Pickle ``algo`` with its template path and ``algo_meta_data`` into
    ``<its output path>/algo_object.pkl``; returns the file's path. (The JAX package's
    engine-side copy records a template path of None as the string "None", which its reader
    then sets on the algorithm; here None stays None.)"""
    os.makedirs(algo.get_output_path(), exist_ok=True)
    data = {"algo_bytes": pickle.dumps(algo), "template_path": template_path, **algo_meta_data}
    pkl_filename = os.path.join(algo.get_output_path(), "algo_object.pkl")
    with open(pkl_filename, "wb") as f_pi:
        f_pi.write(pickle.dumps(data))
    return pkl_filename


def algo_from_pickle(pkl_filename: str, template_path=None, **kwargs: Any):
    """The algo of ``algo_to_pickle``'s file and the rest of its dict (its metadata). Where
    its module is not importable, the template paths given and recorded (and their
    parents) and the pickle's parent folder are put on ``sys.path`` in turn; a recorded
    template path is set on the algo."""
    with open(pkl_filename, "rb") as f_pi:
        data = pickle.loads(f_pi.read())
    if not isinstance(data, dict):
        raise ValueError(f"the data object is {data.__class__}. Dict is expected.")
    if "algo_bytes" not in data:
        raise ValueError(f"key [algo_bytes] not found in {data}. Unable to instantiate.")
    algo_bytes = data.pop("algo_bytes")
    algo_template_path = data.pop("template_path", None)
    candidates: list[str] = []
    for tp in (template_path, algo_template_path):
        if tp is not None and os.path.isdir(str(tp)):
            candidates.append(os.path.abspath(str(tp)))
            candidates.append(os.path.abspath(os.path.join(str(tp), "..")))
    candidates.append(os.path.abspath(os.path.join(os.path.dirname(pkl_filename), "..")))
    try:
        algo = pickle.loads(algo_bytes)
    except ModuleNotFoundError as e:
        last_exc: Exception = e
        algo = None
        for cand in candidates:
            if cand not in sys.path:
                sys.path.insert(0, cand)
            try:
                algo = pickle.loads(algo_bytes)
                break
            except ModuleNotFoundError as e2:
                last_exc = e2
        if algo is None:
            raise ModuleNotFoundError(f"Unable to instantiate the Algo from {pkl_filename}; tried template "
                                      f"paths {candidates}.") from last_exc
    if hasattr(algo, "template_path") and algo_template_path:
        algo.template_path = algo_template_path
    return algo, data


def list_to_python_fire_arg_str(args: list) -> str:
    """A list as one quoted python-fire argument."""
    args_str = ",".join(str(arg) for arg in args)
    return f"'{args_str}'"


def check_and_set_optional_args(params: dict) -> str:
    """``{k: v}`` as a python-fire suffix `` --k=v ...`` (a list quoted as one argument)."""
    cmd_mod_opt = ""
    for k, v in params.items():
        if isinstance(v, dict):
            raise ValueError("Nested dict is not supported.")
        if isinstance(v, list):
            v = list_to_python_fire_arg_str(v)
        cmd_mod_opt += f" --{k}={v}"
    return cmd_mod_opt
