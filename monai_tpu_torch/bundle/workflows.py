"""Bundle workflows: the initialize, run and finalize of a config-driven bundle
(counterpart of monai_tpu/bundle/workflows.py: ``BundleWorkflow``, ``ConfigWorkflow`` and
``PythonicWorkflow``)."""
from __future__ import annotations

import os
import warnings
from abc import ABC, abstractmethod
from collections.abc import Sequence
from pathlib import Path
from typing import Any

from ..utils.misc import ensure_tuple
from .config_parser import ConfigParser
from .properties import InferProperties, MetaProperties, TrainProperties

__all__ = ["BundleWorkflow", "ConfigWorkflow", "PythonicWorkflow"]


class BundleWorkflow(ABC):
    """A workflow of a type (``train`` or ``infer``), with the properties that type
    requires as attributes."""

    supported_train_type: tuple = ("train", "training")
    supported_infer_type: tuple = ("infer", "inference", "eval", "evaluation")

    def __init__(self, workflow_type: str | None = None, workflow: str | None = None,
                 properties_path: str | None = None, meta_file: str | Sequence[str] | None = None,
                 logging_file: str | None = None):
        workflow_type = workflow if workflow is not None else workflow_type
        if workflow_type is None:
            self.properties = dict(MetaProperties)
            self.workflow_type = None
        elif workflow_type.lower() in self.supported_train_type:
            self.properties = {**TrainProperties, **MetaProperties}
            self.workflow_type = "train"
        elif workflow_type.lower() in self.supported_infer_type:
            self.properties = {**InferProperties, **MetaProperties}
            self.workflow_type = "infer"
        else:
            raise ValueError(f"Unsupported workflow type: '{workflow_type}'.")
        self.meta_file = meta_file

    @abstractmethod
    def initialize(self, *args, **kwargs):
        raise NotImplementedError

    @abstractmethod
    def run(self, *args, **kwargs):
        raise NotImplementedError

    @abstractmethod
    def finalize(self, *args, **kwargs):
        raise NotImplementedError

    @abstractmethod
    def _get_property(self, name: str, property: dict):
        raise NotImplementedError

    def _set_property(self, name: str, property: dict, value: Any):
        raise NotImplementedError

    def __getattr__(self, name):
        if name != "properties" and "properties" in self.__dict__ and name in self.properties:
            return self._get_property(name=name, property=self.properties[name])
        raise AttributeError(f"{self.__class__.__name__} object has no attribute {name}")

    def __setattr__(self, name, value):
        if name != "properties" and "properties" in self.__dict__ and name in self.properties:
            self._set_property(name=name, property=self.properties[name], value=value)
        else:
            super().__setattr__(name, value)

    def add_property(self, name: str, required: bool, desc: str | None = None) -> None:
        if name in self.properties:
            warnings.warn(f"property '{name}' already exists, overriding it.")
        self.properties[name] = {"description": desc, "required": required}

    def check_properties(self) -> list[str] | None:
        """The required properties that are missing."""
        return [n for n, p in self.properties.items() if p.get("required", False) and not hasattr(self, n)]


class ConfigWorkflow(BundleWorkflow):
    """A workflow read from config files: ``override`` (``{"id": value}``) is applied to
    the config with ``parser.update`` before anything is parsed; ``initialize``,
    ``run`` and ``finalize`` evaluate the items ``init_id``, ``run_id`` and
    ``final_id`` (each an expression or a list of them, in order)."""

    def __init__(self, config_file: str | Sequence[str], meta_file: str | Sequence[str] | None = None,
                 logging_file: str | None = None, init_id: str = "initialize", run_id: str = "run",
                 final_id: str = "finalize", tracking: str | dict | None = None,
                 workflow_type: str | None = "train", properties_path: str | None = None, **override: Any):
        super().__init__(workflow_type=workflow_type, properties_path=properties_path, meta_file=meta_file)
        self.config_root_path = Path(ensure_tuple(config_file)[0]).parent
        self.parser = ConfigParser()
        self.parser.read_config(f=config_file)
        if meta_file is not None and (not isinstance(meta_file, str) or os.path.exists(meta_file)):
            self.parser.read_meta(f=meta_file)
        self.parser.update(pairs=override)
        self.init_id, self.run_id, self.final_id = init_id, run_id, final_id

    def initialize(self) -> list:
        self.parser.parse(reset=True)
        return self._run_expr(id=self.init_id)

    def run(self) -> list:
        if self.run_id not in self.parser:
            raise ValueError(f"run ID '{self.run_id}' doesn't exist in the config file.")
        return self._run_expr(id=self.run_id)

    def finalize(self) -> list:
        return self._run_expr(id=self.final_id)

    def _run_expr(self, id: str, **kwargs) -> list:
        if id not in self.parser:
            return []
        if isinstance(self.parser[id], list):
            sep = self.parser.ref_resolver.sep
            return [self.parser.get_parsed_content(f"{id}{sep}{i}", **kwargs) for i in range(len(self.parser[id]))]
        return [self.parser.get_parsed_content(id, **kwargs)]

    def _get_prop_id(self, name: str, property: dict):
        prop_id = property.get("id", name)
        if prop_id in self.parser:
            return prop_id
        if property.get("required", False):
            raise KeyError(f"Property '{name}' with config ID '{prop_id}' not in the config.")
        return None

    def _get_property(self, name: str, property: dict):
        if not self.parser.ref_resolver.is_resolved():
            raise RuntimeError("Please execute 'initialize' before getting any parsed content.")
        prop_id = self._get_prop_id(name, property)
        return self.parser.get_parsed_content(id=prop_id) if prop_id is not None else None

    def _set_property(self, name: str, property: dict, value: Any) -> None:
        self.parser[property.get("id", name)] = value
        self.parser.ref_resolver.reset()

    def check_properties(self) -> list[str] | None:
        return [n for n, p in self.properties.items()
                if p.get("required", False) and self._get_prop_id(n, {**p, "required": False}) is None]


class PythonicWorkflow(BundleWorkflow):
    """A workflow written in Python: subclass it and write ``run``. A property is, in this
    order, the value set on the workflow, the cached value of its ``get_<name>`` method,
    or the parsed item of that id of the config and meta files (``override`` applied);
    a required property that none of them gives raises."""

    def __init__(self, workflow_type: str | None = None, workflow: str | None = None, properties_path=None,
                 config_file=None, meta_file=None, logging_file=None, **override):
        super().__init__(workflow_type=workflow or workflow_type, properties_path=properties_path)
        self._props_vals: dict = {}
        self._set_props_vals: dict = {}
        self.parser = ConfigParser()
        if config_file is not None:
            self.parser.read_config(f=config_file)
        if meta_file is not None:
            self.parser.read_meta(f=meta_file)
        self.parser.update(pairs=override)
        self._is_initialized: bool = False

    def initialize(self, *args, **kwargs):
        self._props_vals = {}
        self._is_initialized = True

    def _get_property(self, name: str, property: dict):
        if not self._is_initialized:
            raise RuntimeError("initialize the workflow before getting any properties.")
        if name in self._set_props_vals:
            return self._set_props_vals[name]
        if name in self._props_vals:
            return self._props_vals[name]
        getter = getattr(self, f"get_{name}", None)
        if callable(getter):
            self._props_vals[name] = getter()
            return self._props_vals[name]
        try:
            return self.parser.get_parsed_content(name)
        except Exception as e:
            if property.get("required", False):
                raise KeyError(f"required property {name} is not resolvable") from e
            return None

    def _set_property(self, name: str, property: dict, value) -> None:
        self._set_props_vals[name] = value

    def run(self, *args, **kwargs):
        raise NotImplementedError("subclass a PythonicWorkflow and implement run().")

    def finalize(self, *args, **kwargs):
        pass
