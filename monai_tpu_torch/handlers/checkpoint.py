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

__all__ = ["CheckpointLoader", "CheckpointSaver", "save_checkpoint"]


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


def _state_of(obj: Any) -> Any:
    """What a checkpoint holds of ``obj``: its ``state_dict()``; of an engine, its epoch,
    iteration and max_epochs, as the JAX package saves them; else ``obj`` itself."""
    state = getattr(obj, "state", None)
    if state is not None and hasattr(state, "epoch") and hasattr(state, "iteration"):
        return {"epoch": int(state.epoch), "iteration": int(state.iteration), "max_epochs": int(state.max_epochs)}
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def save_checkpoint(save_dict: Mapping[str, Any], path: str) -> None:
    """Write ``{key: state}`` of ``save_dict`` as one torch file at ``path``, through a
    temporary file and a rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: _state_of(obj) for k, obj in save_dict.items()}, path + ".tmp")
    os.replace(path + ".tmp", path)


class CheckpointSaver:
    """Save ``{key: obj.state_dict()}`` of ``save_dict`` as torch files under
    ``save_dir``, by the JAX package's rules and file names (``file_prefix`` and ``_``
    before each name where it is given):

    - ``save_final``: at the run's end, and where it raises, ``final_filename`` (else
      ``checkpoint_final_iteration=<n>.ckpt``);
    - ``save_key_metric``: at each epoch's end of the engine it is attached to (an
      evaluator's, in a bundle's ``val_handlers``), where the key metric (``key_metric_name``,
      else the engine's) is among the ``key_metric_n_saved`` best so far (greater, or
      equal with ``key_metric_greater_or_equal``; its negative with
      ``key_metric_negative_sign``): ``key_metric_filename``, else
      ``<name>=<metric:.4f>_epoch=<epoch>.ckpt``, and the worst beyond the
      ``key_metric_n_saved`` best is deleted. A fixed ``key_metric_filename`` holds one
      checkpoint only, so it raises with ``key_metric_n_saved > 1``;
    - ``save_interval``: every ``save_interval`` epochs (``epoch_level``) or iterations,
      ``checkpoint_epoch=<n>.ckpt`` or ``checkpoint_iteration=<n>.ckpt``; the oldest beyond
      ``n_saved`` is deleted.

    ``name`` and ``key_metric_save_state`` are taken for the JAX package's signature, which
    adds nothing to a checkpoint for them either."""

    def __init__(self, save_dir: str, save_dict: Mapping[str, Any], name: str | None = None, file_prefix: str = "",
                 save_final: bool = False, final_filename: str | None = None, save_key_metric: bool = False,
                 key_metric_name: str | None = None, key_metric_n_saved: int = 1,
                 key_metric_filename: str | None = None, key_metric_save_state: bool = False,
                 key_metric_greater_or_equal: bool = False, key_metric_negative_sign: bool = False,
                 epoch_level: bool = True, save_interval: int = 0, n_saved: int | None = None):
        if save_dir is None:
            raise AssertionError("must provide directory to save the checkpoints.")
        if not save_dict:
            raise AssertionError("must provide source objects to save.")
        if key_metric_filename is not None and key_metric_n_saved > 1:
            raise ValueError("if using fixed filename to save the best metric model, we should only save 1 model.")
        self.save_dir = save_dir
        self.save_dict = dict(save_dict)
        self.file_prefix = file_prefix
        self.save_final = save_final
        self.final_filename = final_filename
        self.save_key_metric = save_key_metric
        self.key_metric_name = key_metric_name
        self.key_metric_n_saved = key_metric_n_saved
        self.key_metric_filename = key_metric_filename
        self.key_metric_save_state = key_metric_save_state
        self.key_metric_greater_or_equal = key_metric_greater_or_equal
        self.key_metric_negative_sign = key_metric_negative_sign
        self.epoch_level = epoch_level
        self.save_interval = save_interval
        self.n_saved = n_saved
        self._key_saved: list[tuple[float, str]] = []  # (metric, path), best first
        self._interval_saved: list[str] = []  # oldest first

    def attach(self, engine) -> None:
        if self.save_final:
            engine.add_event_handler(Events.COMPLETED, self.completed)
            engine.add_event_handler(Events.EXCEPTION_RAISED, self.exception_raised)
        if self.save_key_metric:
            engine.add_event_handler(Events.EPOCH_COMPLETED, self.metrics_completed)
        if self.save_interval > 0:
            event = Events.EPOCH_COMPLETED if self.epoch_level else Events.ITERATION_COMPLETED
            engine.add_event_handler(event, self.interval_completed, every=self.save_interval)

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{self.file_prefix}_{name}" if self.file_prefix else name)

    def completed(self, engine) -> None:
        name = self.final_filename or f"checkpoint_final_iteration={engine.state.iteration}.ckpt"
        save_checkpoint(self.save_dict, self._path(name))

    def exception_raised(self, engine, e: Exception | None = None) -> None:
        self.completed(engine)
        if e is not None:
            raise e

    def metrics_completed(self, engine) -> None:
        key_name = self.key_metric_name or engine.state.key_metric_name
        if key_name is None or key_name not in engine.state.metrics:
            return
        metric = float(engine.state.metrics[key_name])
        if self.key_metric_negative_sign:
            metric = -metric
        saved = self._key_saved
        if (len(saved) < self.key_metric_n_saved or metric > saved[-1][0]
                or (self.key_metric_greater_or_equal and metric >= saved[-1][0])):
            path = self._path(self.key_metric_filename or f"{key_name}={metric:.4f}_epoch={engine.state.epoch}.ckpt")
            save_checkpoint(self.save_dict, path)
            saved.append((metric, path))
            saved.sort(key=lambda t: -t[0])
            while len(saved) > self.key_metric_n_saved:
                _remove_path(saved.pop()[1])

    def interval_completed(self, engine) -> None:
        tag = f"epoch={engine.state.epoch}" if self.epoch_level else f"iteration={engine.state.iteration}"
        path = self._path(f"checkpoint_{tag}.ckpt")
        save_checkpoint(self.save_dict, path)
        self._interval_saved.append(path)
        while self.n_saved is not None and len(self._interval_saved) > self.n_saved:
            _remove_path(self._interval_saved.pop(0))


def _remove_path(path: str) -> None:
    """Delete a checkpoint file that is no longer kept (one already gone is no error)."""
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
