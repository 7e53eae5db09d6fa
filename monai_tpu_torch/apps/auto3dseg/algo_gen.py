"""Auto3DSeg's in-code algorithm ``SegAlgo`` (counterpart of ``SegAlgo`` in
monai_tpu/apps/auto3dseg/algo_gen.py), beside the ``Algo`` and ``AlgoGen`` interfaces,
which are ``auto3dseg.algo_gen``'s.

``SegAlgo`` trains without a bundle config: a UNet (channels 16-256, strides 2, two
residual units, instance norm) or a SegResNet (16 filters) for the labels of the data
statistics, on crops of the datalist made by a pipeline filled from them (the median
spacing), with ``DiceCELoss`` and ``torch.optim.AdamW`` at optax's ``adamw`` defaults (as
the port's bundle templates; weight decay 1e-4). It writes ``model/model_final.pt``
(``{"model": state_dict}``) and ``result.json``, whose ``best_metric`` is the negative of
the last loss; ``predict`` runs each file through a Gaussian-weighted sliding window.
``device`` (None: the CUDA card) is where the images load and the network runs.
"""
from __future__ import annotations

import json
import os
from typing import Any

import torch

from ...auto3dseg.algo_gen import Algo, AlgoGen
from ...utils.backend import resolve_device

__all__ = ["Algo", "AlgoGen", "SegAlgo"]


class SegAlgo(Algo):
    """A trainable segmentation algorithm built from the data statistics (``data_stats``,
    a DataAnalyzer result or a json or yaml file of one) and a datalist of
    ``{"image", "label"}`` files."""

    def __init__(self, name: str, network: str, output_path: str, data_stats: dict | None = None,
                 datalist: list | None = None, roi_size=(96, 96, 96), max_epochs: int = 100, lr: float = 1e-3,
                 device=None):
        self.name = name
        self.network_name = network
        self.output_path = output_path
        self.data_stats = data_stats or {}
        self.datalist = datalist or []
        self.roi_size = tuple(roi_size)
        self.max_epochs = max_epochs
        self.lr = lr
        self.device = None if device is None else str(device)
        self.best_metric: float = -1.0
        self._net = None

    def __getstate__(self) -> dict:
        # a pickle or a deep copy holds no network: predict loads the checkpoint
        state = dict(self.__dict__)
        state["_net"] = None
        return state

    def _num_classes(self) -> int:
        labels = self.data_stats.get("stats_summary", {}).get("label_stats", {}).get("labels", [0, 1])
        return max(2, len(labels))

    def build_network(self) -> torch.nn.Module:
        """A new network (weights from seed 0) for the statistics' labels."""
        from ...networks.nets import SegResNet, UNet

        common = dict(generator=torch.Generator().manual_seed(0), device=resolve_device(self.device))
        if self.network_name == "segresnet":
            self._net = SegResNet(spatial_dims=3, init_filters=16, in_channels=1, out_channels=self._num_classes(),
                                  **common)
        else:
            self._net = UNet(spatial_dims=3, in_channels=1, out_channels=self._num_classes(),
                             channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2, **common)
        return self._net

    def get_transforms(self, keys=("image", "label")):
        """Load, channel first, RAS, the median spacing, the foreground's intensities
        normalised, two crops an item (one about the label, one not), a random flip."""
        from ...transforms import (Compose, EnsureChannelFirstd, LoadImaged, NormalizeIntensityd, Orientationd,
                                   RandCropByPosNegLabeld, RandFlipd, Spacingd)

        spacing = self.data_stats.get("stats_summary", {}).get("image_stats", {}).get("spacing", {}).get(
            "median", [1.0, 1.0, 1.0])
        return Compose([
            LoadImaged(keys=list(keys), device=resolve_device(self.device)),
            EnsureChannelFirstd(keys=list(keys), channel_dim="no_channel"),
            Orientationd(keys=list(keys), axcodes="RAS"),
            Spacingd(keys=list(keys), pixdim=tuple(spacing), mode=["bilinear", "nearest"][:len(keys)]),
            NormalizeIntensityd(keys=keys[0], nonzero=True),
            RandCropByPosNegLabeld(keys=list(keys), label_key=keys[-1], spatial_size=self.roi_size, pos=1, neg=1,
                                   num_samples=2),
            RandFlipd(keys=list(keys), prob=0.5, spatial_axis=0),
        ])

    def set_data_stats(self, data_stats: dict | str) -> None:
        if isinstance(data_stats, str):
            with open(data_stats) as f:
                if data_stats.endswith(".json"):
                    data_stats = json.load(f)
                else:
                    import yaml

                    data_stats = yaml.safe_load(f)
        self.data_stats = data_stats

    def train(self, params: dict | None = None) -> dict:
        """Train a new network ``max_epochs`` (default the algo's) over the datalist at
        ``batch_size`` items (default 2) and ``lr`` (default the algo's); save it and
        ``result.json``. Returns the loss history and the score."""
        from ...data import DataLoader, Dataset
        from ...handlers.checkpoint import save_checkpoint
        from ...losses import DiceCELoss

        params = params or {}
        net = self.build_network().train()
        optimizer = torch.optim.AdamW(net.parameters(), lr=params.get("lr", self.lr), betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
        loss_fn = DiceCELoss(to_onehot_y=True, softmax=True)
        loader = DataLoader(Dataset(self.datalist, self.get_transforms()), batch_size=params.get("batch_size", 2),
                            shuffle=True)
        history = []
        for _epoch in range(params.get("max_epochs", self.max_epochs)):
            for batch in loader:
                x, y = (getattr(batch[k], "data", batch[k]) for k in ("image", "label"))
                optimizer.zero_grad(set_to_none=True)
                loss = loss_fn(net(x), y)
                loss.backward()
                optimizer.step()
                history.append(loss.item())
        save_checkpoint({"model": net}, self._checkpoint())
        self.best_metric = -history[-1] if history else -1.0
        os.makedirs(self.output_path, exist_ok=True)
        with open(os.path.join(self.output_path, "result.json"), "w") as f:
            json.dump({"best_metric": self.best_metric}, f)
        return {"loss_history": history, "best_metric": self.best_metric}

    def _checkpoint(self) -> str:
        return os.path.join(self.output_path, "model", "model_final.pt")

    def get_score(self, *args, **kwargs) -> float:
        return self.best_metric

    def get_output_path(self) -> str:
        return self.output_path

    def get_inferer(self, roi_size=None, sw_batch_size: int = 4, overlap: float = 0.25):
        from ...inferers import SlidingWindowInferer

        return SlidingWindowInferer(roi_size=roi_size or self.roi_size, sw_batch_size=sw_batch_size, overlap=overlap,
                                    mode="gaussian")

    def _network(self) -> torch.nn.Module:
        """The trained network: the one ``train`` left, else a new one with the
        checkpoint's weights where there is one."""
        if self._net is None:
            net = self.build_network()
            if os.path.exists(self._checkpoint()):
                state = torch.load(self._checkpoint(), map_location=next(net.parameters()).device, weights_only=True)
                net.load_state_dict(state["model"])
        return self._net

    def predict(self, params: dict) -> list[Any]:
        """The sliding-window logits of each of ``params["files"]`` (loaded, channel first,
        RAS, the foreground's intensities normalised), on the network's device."""
        from ...transforms import Compose, EnsureChannelFirstd, LoadImaged, NormalizeIntensityd, Orientationd

        net = self._network().eval()
        inferer = self.get_inferer()
        xform = Compose([
            LoadImaged(keys=["image"], device=next(net.parameters()).device),
            EnsureChannelFirstd(keys=["image"], channel_dim="no_channel"),
            Orientationd(keys=["image"], axcodes="RAS"),
            NormalizeIntensityd(keys="image", nonzero=True),
        ])
        preds = []
        with torch.no_grad():
            for f in params.get("files", []):
                x = xform({"image": f})["image"].data[None]
                preds.append(inferer(x, net))
        return preds
