"""BundleGen and BundleAlgo (counterpart of monai_tpu/apps/auto3dseg/bundle_gen.py): one
on-disk training bundle (``<name>_<fold>/configs/train.json``) an algorithm template and
fold, filled from the dataset's statistics and run through the port's ``ConfigWorkflow``.

The templates are the JAX package's but for two items: ``imports`` (``torch``, not
``optax``) and ``optimizer``, ``torch.optim.AdamW`` with optax's ``adamw`` defaults
(weight decay 1e-4, betas 0.9 and 0.999, eps 1e-8; torch's weight decay is 0.01). A
trained bundle's weights are ``model/model_final.pt`` (``{"model": state_dict}``) beside
its configs, and its score the negative of its last iteration's loss.

``device`` (None: the CUDA card) goes to the bundle's network, trainer and image loader
as overrides of the config, which itself names no device.
"""
from __future__ import annotations

import json
import os
from copy import deepcopy
from typing import Callable

import torch

from ...utils.enums import AlgoKeys
from .algo_gen import Algo, AlgoGen

__all__ = ["BundleAlgo", "BundleGen", "algo_templates", "register_algo_template"]


def _stats_of(data_stats: dict) -> dict:
    s = data_stats.get("stats_summary", data_stats) or {}
    image = s.get("image_stats", {})
    label = s.get("label_stats", {})
    intensity = image.get("intensity", {})
    return {
        "spacing": [float(x) for x in image.get("spacing", {}).get("median", [1.0, 1.0, 1.0])],
        "n_classes": int(max(2, len(label.get("labels", [0, 1])))),
        "mean": float(intensity.get("mean", 0.0)),
        "std": float(max(intensity.get("std", 1.0), 1e-3)),
    }


def _base_train_config(stats: dict, roi_size, params: dict) -> dict:
    """What every template shares: the data pipeline, the loss, the optimizer, the trainer."""
    keys = ["image", "label"]
    return {
        "imports": ["$import torch"],
        "bundle_root": ".",
        "ckpt_dir": "$@bundle_root + '/model'",
        "pixdim": stats["spacing"],
        "n_classes": stats["n_classes"],
        "roi_size": list(roi_size),
        "lr": params.get("lr", 1e-3),
        "max_epochs": params.get("max_epochs", 2),
        "batch_size": params.get("batch_size", 2),
        "datalist": [],  # each fold's, from BundleGen
        "train_transforms": {
            "_target_": "Compose",
            "transforms": [
                {"_target_": "LoadImaged", "keys": keys},
                {"_target_": "EnsureChannelFirstd", "keys": keys, "channel_dim": "no_channel"},
                {"_target_": "Orientationd", "keys": keys, "axcodes": "RAS"},
                {"_target_": "Spacingd", "keys": keys, "pixdim": "@pixdim", "mode": ["bilinear", "nearest"]},
                {"_target_": "NormalizeIntensityd", "keys": "image", "nonzero": True},
                {"_target_": "RandCropByPosNegLabeld", "keys": keys, "label_key": "label",
                 "spatial_size": "@roi_size", "pos": 1, "neg": 1, "num_samples": 2},
                {"_target_": "RandFlipd", "keys": keys, "prob": 0.5, "spatial_axis": 0},
            ],
        },
        "dataset": {"_target_": "Dataset", "data": "@datalist", "transform": "@train_transforms"},
        "dataloader": {"_target_": "DataLoader", "dataset": "@dataset", "batch_size": "@batch_size",
                       "shuffle": True},
        "loss": {"_target_": "DiceCELoss", "to_onehot_y": True, "softmax": True},
        "optimizer": {"_target_": "torch.optim.AdamW", "_mode_": "partial", "lr": "@lr", "weight_decay": 1e-4,
                      "betas": [0.9, 0.999], "eps": 1e-8},
        "trainer": {
            "_target_": "SupervisedTrainer",
            "max_epochs": "@max_epochs",
            "train_data_loader": "@dataloader",
            "network": "@network",
            "optimizer": "@optimizer",
            "loss_function": "@loss",
            "decollate": False,
        },
        "run": ["$@trainer.run()"],
    }


def _unet_template(stats: dict, params: dict) -> dict:
    cfg = _base_train_config(stats, params.get("roi_size", (96, 96, 96)), params)
    cfg["network"] = {"_target_": "UNet", "spatial_dims": 3, "in_channels": 1, "out_channels": "@n_classes",
                      "channels": [16, 32, 64, 128, 256], "strides": [2, 2, 2, 2], "num_res_units": 2}
    return cfg


def _segresnet_template(stats: dict, params: dict) -> dict:
    cfg = _base_train_config(stats, params.get("roi_size", (96, 96, 96)), params)
    cfg["network"] = {"_target_": "SegResNet", "spatial_dims": 3, "init_filters": 16, "in_channels": 1,
                      "out_channels": "@n_classes"}
    return cfg


def _swinunetr_template(stats: dict, params: dict) -> dict:
    cfg = _base_train_config(stats, params.get("roi_size", (96, 96, 96)), params)
    cfg["network"] = {"_target_": "SwinUNETR", "in_channels": 1, "out_channels": "@n_classes", "feature_size": 24,
                      "spatial_dims": 3}
    return cfg


algo_templates: dict[str, Callable[[dict, dict], dict]] = {
    "unet": _unet_template,
    "segresnet": _segresnet_template,
    "swinunetr": _swinunetr_template,
}


def register_algo_template(name: str, fn: Callable[[dict, dict], dict]) -> None:
    """Register a template: ``fn(stats, params)`` gives a bundle config dict."""
    algo_templates[name] = fn


class BundleAlgo(Algo):
    """A generated bundle: ``fill_template_config``, ``export_to_disk``, ``train`` (its
    ``train.json`` through ``ConfigWorkflow``), ``predict`` (a sliding window with the
    trained weights). ``device=None`` is the CUDA card."""

    def __init__(self, template_name: str = "unet", template_path: str | None = None, device=None):
        self.template_name = template_name
        self.template_path = template_path  # a user's template, a json file
        self.device = None if device is None else str(device)
        self.data_stats_files: str | dict | None = None
        self.data_list_file: str | dict | None = None
        self.fill_records: dict = {}
        self.cfg: dict = {}
        self.output_path = ""
        self.best_metric = -1.0
        self.name = template_name

    def __getstate__(self) -> dict:
        # a pickle holds no network: predict loads the checkpoint beside the configs
        state = dict(self.__dict__)
        state.pop("_trained_network", None)
        return state

    def set_data_stats(self, data_stats_files: str | dict) -> None:
        self.data_stats_files = data_stats_files

    def set_data_source(self, data_src_cfg: str | dict) -> None:
        self.data_list_file = data_src_cfg

    def _load_stats(self) -> dict:
        ds = self.data_stats_files
        if isinstance(ds, str):
            with open(ds) as f:
                ds = json.load(f)
        return ds or {}

    def fill_template_config(self, data_stats: dict | None = None, output_path: str = "", **params) -> dict:
        """The template's config filled with the dataset's statistics and ``params``
        (``roi_size``, ``lr``, ``max_epochs``, ``batch_size``)."""
        stats = _stats_of(data_stats if data_stats is not None else self._load_stats())
        if self.template_path:
            with open(self.template_path) as f:
                cfg = json.load(f)
            cfg.update({"pixdim": stats["spacing"], "n_classes": stats["n_classes"]})
        else:
            if self.template_name not in algo_templates:
                raise ValueError(f"unknown algo template '{self.template_name}'; available: {sorted(algo_templates)}")
            cfg = algo_templates[self.template_name](stats, params)
        self.cfg = cfg
        self.fill_records = {"stats": stats, "params": params}
        return cfg

    def export_to_disk(self, output_path: str, algo_name: str, **kwargs) -> None:
        """Write the filled config to ``<output_path>/<algo_name>/configs/train.json``."""
        self.name = algo_name
        self.output_path = os.path.join(output_path, algo_name)
        cfg_dir = os.path.join(self.output_path, "configs")
        os.makedirs(cfg_dir, exist_ok=True)
        cfg = deepcopy(self.cfg)
        cfg["bundle_root"] = self.output_path
        with open(os.path.join(cfg_dir, "train.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
        with open(os.path.join(self.output_path, "fill_records.json"), "w") as f:
            json.dump(self.fill_records, f, indent=2, default=str)

    def _config_file(self) -> str:
        return os.path.join(self.output_path, "configs", "train.json")

    def _checkpoint(self) -> str:
        return os.path.join(self.output_path, "model", "model_final.pt")

    def _device_overrides(self) -> dict:
        if self.device is None:
            return {}
        return {"network::device": self.device, "trainer::device": self.device,
                "train_transforms::transforms::0::device": self.device}

    def train(self, train_params: dict | None = None, device_setting: dict | None = None) -> dict:
        """Run the bundle's ``train.json`` in this process (``train_params`` override its
        items), save the trained weights beside it and ``result.json`` with the score."""
        from ...bundle.workflows import ConfigWorkflow

        wf = ConfigWorkflow(config_file=self._config_file(), workflow_type="train",
                            **{**dict(train_params or {}), **self._device_overrides()})
        wf.initialize()
        wf.run()
        trainer = wf.parser.get_parsed_content("trainer")
        self._trained_network = trainer.network
        os.makedirs(os.path.dirname(self._checkpoint()), exist_ok=True)
        torch.save({"model": trainer.network.state_dict()}, self._checkpoint())
        out = trainer.state.output
        if isinstance(out, list) and out and isinstance(out[0], dict):
            out = out[0]
        loss = out.get("loss") if isinstance(out, dict) else None
        self.best_metric = -float(loss) if loss is not None else -1.0
        result = {"best_metric": self.best_metric}
        with open(os.path.join(self.output_path, "result.json"), "w") as f:
            json.dump(result, f)
        return result

    def get_score(self, *args, **kwargs) -> float:
        if self.best_metric == -1.0 and self.output_path:
            rp = os.path.join(self.output_path, "result.json")
            if os.path.exists(rp):
                with open(rp) as f:
                    self.best_metric = float(json.load(f).get("best_metric", -1.0))
        return self.best_metric

    def get_output_path(self) -> str:
        return self.output_path

    def get_inferer(self, roi_size=None, sw_batch_size: int = 4, overlap: float = 0.25):
        from ...inferers import SlidingWindowInferer

        roi = roi_size or tuple(self.cfg.get("roi_size", (96, 96, 96)))
        return SlidingWindowInferer(roi_size=roi, sw_batch_size=sw_batch_size, overlap=overlap, mode="gaussian")

    def _network(self) -> torch.nn.Module:
        """The trained network: the one ``train`` left, else the config's network with the
        checkpoint's weights where there is one."""
        net = getattr(self, "_trained_network", None)
        if net is None:
            from ...bundle.config_parser import ConfigParser

            parser = ConfigParser()
            parser.read_config(self._config_file())
            if self.device is not None:
                parser["network::device"] = self.device
            net = parser.get_parsed_content("network")
            if os.path.exists(self._checkpoint()):
                state = torch.load(self._checkpoint(), map_location=next(net.parameters()).device, weights_only=True)
                net.load_state_dict(state["model"])
            self._trained_network = net
        return net

    def predict(self, predict_files: list | dict, predict_params: dict | None = None) -> list:
        """The sliding-window output of each item of ``predict_files`` (a volume, a file, or
        an ``{"image": ...}`` dict; a dict's ``files``), a file loaded, made channel-first
        and oriented to RAS on the network's device, without further preprocessing, as the
        JAX package predicts."""
        params = dict(predict_params or {})
        files = predict_files.get("files", predict_files) if isinstance(predict_files, dict) else predict_files
        net = self._network().eval()
        device = next(net.parameters()).device
        inferer = self.get_inferer(**{k: v for k, v in params.items() if k in ("roi_size", "sw_batch_size", "overlap")})
        outs = []
        for item in files:
            arr = item.get("image", item) if isinstance(item, dict) else item
            if isinstance(arr, str):
                from ...transforms import Compose, EnsureChannelFirstd, LoadImaged, Orientationd

                pre = Compose([LoadImaged(keys="image", device=device),
                               EnsureChannelFirstd(keys="image", channel_dim="no_channel"),
                               Orientationd(keys="image", axcodes="RAS")])
                arr = pre({"image": arr})["image"].data
            x = torch.as_tensor(arr, dtype=torch.float32, device=device)
            if x.ndim == 4:
                x = x[None]
            with torch.no_grad():
                outs.append(inferer(x, net))
        return outs


class BundleGen(AlgoGen):
    """One ``BundleAlgo`` a template and fold. ``device=None`` is the CUDA card."""

    def __init__(self, algo_path: str = ".", algos: list[str] | str | None = None,
                 templates_path_or_url: str | None = None, data_stats_filename: str | dict | None = None,
                 data_src_cfg_name: str | dict | None = None, device=None):
        self.algo_path = algo_path
        self.algos = list(algo_templates) if algos is None else ([algos] if isinstance(algos, str) else list(algos))
        self.templates_path = templates_path_or_url
        self.data_stats_filename = data_stats_filename
        self.data_src_cfg_name = data_src_cfg_name
        self.device = device
        self.history: list[dict] = []

    def set_data_stats(self, data_stats_filename: str | dict) -> None:
        self.data_stats_filename = data_stats_filename

    def set_data_source(self, data_src_cfg_name: str | dict) -> None:
        self.data_src_cfg_name = data_src_cfg_name

    def get_history(self) -> list[dict]:
        return self.history

    def generate(self, output_folder: str = ".", num_fold: int = 5, datalist: list | None = None,
                 **template_params) -> list[dict]:
        """Fill and export one bundle a (template, fold), ``<template>_<fold>``, training on
        every fold of ``datalist`` but its own (fold i is items i, i + num_fold, ...);
        returns the history of ``{AlgoKeys.ID, AlgoKeys.ALGO, AlgoKeys.IS_TRAINED}``."""
        os.makedirs(output_folder, exist_ok=True)
        self.history = []
        for name in self.algos:
            for fold in range(num_fold):
                algo = BundleAlgo(template_name=name, template_path=self.templates_path, device=self.device)
                if self.data_stats_filename is not None:
                    algo.set_data_stats(self.data_stats_filename)
                cfg = algo.fill_template_config(**template_params)
                if datalist is not None:
                    folds = [datalist[i::num_fold] for i in range(num_fold)]
                    cfg["datalist"] = [x for i, f in enumerate(folds) if i != fold for x in f]
                algo_name = f"{name}_{fold}"
                algo.export_to_disk(output_folder, algo_name)
                self.history.append({AlgoKeys.ID: algo_name, AlgoKeys.ALGO: algo, AlgoKeys.IS_TRAINED: False})
        return self.history
