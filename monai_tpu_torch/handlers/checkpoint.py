"""CheckpointLoader and CheckpointSaver (counterpart of monai_tpu/handlers/checkpoint.py).
The port's checkpoint is a torch file, ``{key: state_dict}`` as torch MONAI's is, not the
JAX package's orbax directory; a JAX checkpoint comes over through
``networks.weights.unet_state_dict_from_jax`` or ``swin_state_dict_from_jax``."""
from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any

import torch

from ..engines.events import Events

__all__ = ["CheckpointLoader", "CheckpointSaver"]


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


class CheckpointSaver:
    """At the run's end, and where it raises, save ``{key: obj.state_dict()}`` of
    ``save_dict`` as one torch file ``save_dir/final_filename`` (``save_final``; else
    ``checkpoint_final_iteration=<n>.ckpt``). Saving on the key metric
    (``save_key_metric``) and every n epochs are not ported; the former raises."""

    def __init__(self, save_dir: str, save_dict: Mapping[str, Any], save_final: bool = False,
                 final_filename: str | None = None, save_key_metric: bool = False):
        if save_dir is None:
            raise AssertionError("must provide directory to save the checkpoints.")
        if not save_dict:
            raise AssertionError("must provide source objects to save.")
        if save_key_metric:
            raise NotImplementedError("CheckpointSaver(save_key_metric=True) is not ported")
        self.save_dir = save_dir
        self.save_dict = dict(save_dict)
        self.save_final = save_final
        self.final_filename = final_filename

    def attach(self, engine) -> None:
        if self.save_final:
            engine.add_event_handler(Events.COMPLETED, self.completed)
            engine.add_event_handler(Events.EXCEPTION_RAISED, self.exception_raised)

    def completed(self, engine) -> None:
        """Write the state dicts, through a temporary file and a rename."""
        name = self.final_filename or f"checkpoint_final_iteration={engine.state.iteration}.ckpt"
        path = os.path.join(self.save_dir, name)
        os.makedirs(self.save_dir, exist_ok=True)
        torch.save({k: obj.state_dict() for k, obj in self.save_dict.items()}, path + ".tmp")
        os.replace(path + ".tmp", path)

    def exception_raised(self, engine, e: Exception | None = None) -> None:
        self.completed(engine)
        if e is not None:
            raise e
