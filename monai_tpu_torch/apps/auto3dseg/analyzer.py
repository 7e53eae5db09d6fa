"""Auto3DSeg's data analysis (counterpart of monai_tpu/apps/auto3dseg/analyzer.py): each
case's shape, spacing, intensity and label statistics, and their summary over the
dataset, written as ``datastats.json`` (or yaml) for the algorithm templates.

The cases load through the port's ``LoadImaged``, ``EnsureChannelFirstd`` and
``Orientationd`` on ``device`` (the card by default) and are reduced there. The JAX
package reduces a host float32 array with numpy; here the sums run in float64 and the
percentiles interpolate (numpy's "linear") in float64 between the two float32 order
statistics of a sort, so each number is numpy's within 1e-6 relative. A sort, not
``torch.quantile``, which refuses inputs of more than 2^24 elements (a 512x512x90 CT
has 23.6 M).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ...auto3dseg.operations import percentiles as _percentiles
from ...data.affine_utils import affine_to_spacing
from ...transforms.compose import Compose
from ...transforms.dictionary import EnsureChannelFirstd, LoadImaged, Orientationd
from ...utils.backend import resolve_device
from ...utils.enums import StrEnum

__all__ = ["DataAnalyzer", "strenum_representer"]


def _intensity(values: torch.Tensor) -> dict:
    x = values.double()
    mean = x.mean()
    p_lo, p_hi = _percentiles(values, (0.5, 99.5))
    return {"mean": mean.item(), "std": (x - mean).square().mean().sqrt().item(),
            "percentile_00_5": p_lo, "percentile_99_5": p_hi}


class DataAnalyzer:
    """Dataset-wide statistics for Auto3DSeg. ``datalist`` is a datalist dict or a json
    file of one (its ``training`` items); relative paths are under ``dataroot``.
    ``device=None`` is the CUDA card; pass ``device="cpu"`` for the CPU. The other
    arguments are taken for the JAX package's signature and change nothing."""

    def __init__(self, datalist: str | dict, dataroot: str = "", output_path: str = "./datastats.yaml",
                 average: bool = True, do_ccp: bool = False, device=None, worker: int = 4,
                 image_key: str = "image", label_key: str | None = "label", hist_bins: int = 0,
                 hist_range: list | None = None, fmt: str = "yaml", histogram_only: bool = False, **extra_params):
        self.datalist = datalist
        self.dataroot = dataroot
        self.output_path = output_path
        self.device = resolve_device(device)
        self.image_key = image_key
        self.label_key = label_key
        self.fmt = fmt

    def _load_datalist(self) -> list[dict]:
        if isinstance(self.datalist, str):
            with open(self.datalist) as f:
                dl = json.load(f)
        else:
            dl = dict(self.datalist)
        out = []
        for item in dl.get("training", []):
            entry = dict(item) if isinstance(item, dict) else {self.image_key: item}
            for k, v in entry.items():
                if isinstance(v, str) and self.dataroot and not os.path.isabs(v):
                    entry[k] = os.path.join(self.dataroot, v)
            out.append(entry)
        return out

    def _case_stats(self, item: dict) -> dict:
        keys = [self.image_key] + ([self.label_key] if self.label_key and self.label_key in item else [])
        xform = Compose([
            LoadImaged(keys=keys, allow_missing_keys=True, device=self.device),
            EnsureChannelFirstd(keys=keys, channel_dim="no_channel", allow_missing_keys=True),
            Orientationd(keys=keys, axcodes="RAS", allow_missing_keys=True),
        ])
        d = xform(dict(item))
        img = d[self.image_key]
        arr = img.data.float()
        stats: dict[str, Any] = {
            "image_stats": {
                "shape": list(arr.shape[1:]),
                "channels": int(arr.shape[0]),
                "spacing": affine_to_spacing(np.asarray(img.affine)).tolist(),
                "intensity": {"max": arr.max().item(), "min": arr.min().item(), **_intensity(arr)},
            }
        }
        if self.label_key and self.label_key in d:
            lab = d[self.label_key].data
            fg_mask = lab > 0
            n_fg = int(fg_mask.sum().item())
            fg = arr[fg_mask] if n_fg else arr.reshape(-1)
            stats["label_stats"] = {
                "labels": [int(v) for v in torch.unique(lab).tolist()],
                "foreground_percentage": n_fg / fg_mask.numel(),
                "image_foreground_intensity": _intensity(fg),
            }
        return stats

    def get_all_case_stats(self, key: str = "training", transform_list=None) -> dict:
        """Each case's statistics and their summary; written to ``output_path`` (json where
        ``fmt`` is "json" or the path ends in .json, else yaml) where it is given."""
        case_stats = [self._case_stats(item) for item in self._load_datalist()]
        result = {"stats_summary": self._summarize(case_stats), "stats_by_cases": case_stats,
                  "n_cases": len(case_stats)}
        if self.output_path:
            os.makedirs(os.path.dirname(os.path.abspath(self.output_path)), exist_ok=True)
            with open(self.output_path, "w") as f:
                if self.fmt == "json" or str(self.output_path).endswith(".json"):
                    json.dump(result, f, indent=2)
                else:
                    import yaml

                    yaml.safe_dump(result, f)
        return result

    @staticmethod
    def _summarize(case_stats: list[dict]) -> dict:
        if not case_stats:
            return {}
        shapes = np.asarray([c["image_stats"]["shape"] for c in case_stats], dtype=float)
        spacings = np.asarray([c["image_stats"]["spacing"] for c in case_stats], dtype=float)
        means = np.asarray([c["image_stats"]["intensity"]["mean"] for c in case_stats])
        stds = np.asarray([c["image_stats"]["intensity"]["std"] for c in case_stats])
        summary = {
            "image_stats": {
                "shape": {"median": np.median(shapes, 0).tolist(), "min": shapes.min(0).tolist(),
                          "max": shapes.max(0).tolist()},
                "spacing": {"median": np.median(spacings, 0).tolist(), "min": spacings.min(0).tolist(),
                            "max": spacings.max(0).tolist()},
                "intensity": {"mean": float(means.mean()), "std": float(stds.mean())},
            }
        }
        label_sets = [c["label_stats"]["labels"] for c in case_stats if "label_stats" in c]
        if label_sets:
            all_labels = sorted({v for s in label_sets for v in s})
            summary["label_stats"] = {"labels": all_labels, "n_classes": len(all_labels)}
        return summary


def strenum_representer(dumper, data):
    """A yaml representer writing a ``StrEnum`` member as its plain string; registered on
    ``yaml.SafeDumper`` when this module is imported, so that reports keyed by
    ``DataStatsKeys`` and the like dump with ``yaml.safe_dump``."""
    return dumper.represent_scalar("tag:yaml.org,2002:str", data.value)


try:
    import yaml

    yaml.SafeDumper.add_multi_representer(StrEnum, strenum_representer)
except ImportError:  # no yaml: nothing to register on
    pass
