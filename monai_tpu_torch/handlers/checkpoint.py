"""CheckpointLoader (counterpart of monai_tpu/handlers/checkpoint.py). The port's
checkpoint is a torch file, as torch MONAI's is, not the JAX package's orbax directory;
a JAX checkpoint comes over through ``networks.weights.unet_state_dict_from_jax``."""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from ..engines.events import Events

__all__ = ["CheckpointLoader"]


class CheckpointLoader:
    """At the engine's start, load the torch file ``load_path`` into each object of
    ``load_dict`` (``{"model": network}``) with ``load_state_dict(strict=...)``: the
    file's entry of the same key, or the whole file where it is a bare state dict and
    ``load_dict`` has one key. ``map_location`` defaults to the engine's device."""

    def __init__(self, load_path: str, load_dict: Mapping[str, Any], map_location=None, strict: bool = True):
        if load_path is None:
            raise AssertionError("must provide clear path to load checkpoint.")
        if not load_dict:
            raise AssertionError("must provide target objects to load.")
        self.load_path = load_path
        self.load_dict = dict(load_dict)
        self.map_location = map_location
        self.strict = strict

    def attach(self, engine) -> None:
        engine.add_event_handler(Events.STARTED, self)

    def __call__(self, engine) -> None:
        location = self.map_location if self.map_location is not None else getattr(engine.state, "device", None)
        checkpoint = torch.load(self.load_path, map_location=location, weights_only=True)
        if len(self.load_dict) == 1:
            key = next(iter(self.load_dict))
            if key not in checkpoint:  # a bare state dict
                checkpoint = {key: checkpoint}
        for key, obj in self.load_dict.items():
            if key not in checkpoint:
                if self.strict:
                    raise KeyError(f"checkpoint {self.load_path} has no entry {key!r}")
                continue
            obj.load_state_dict(checkpoint[key], strict=self.strict)
