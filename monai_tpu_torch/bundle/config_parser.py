"""ConfigParser: a bundle config read from JSON or YAML files, its DSL, and lazy
resolution of its items (counterpart of monai_tpu/bundle/config_parser.py).

The syntax: ``@id`` references an item, ``$expr`` is a Python expression, ``%id`` (or
``%file.json::id``) copies another part of the config as text, a ``_target_`` dict
instantiates a component, and ``::`` (or ``#``) separates the keys of an id. The
expressions see ``json``, ``re``, ``np``/``numpy``, ``torch`` and the port, also as
``monai``.
"""
from __future__ import annotations

import json
import re
from collections.abc import Sequence
from copy import deepcopy
from pathlib import Path
from typing import Any

from ..utils.misc import ensure_tuple
from ..utils.module import optional_import
from .config_item import ComponentLocator, ConfigComponent, ConfigExpression, ConfigItem
from .reference_resolver import ReferenceResolver
from .utils import ID_REF_KEY, ID_SEP_KEY, MACRO_KEY

__all__ = ["ConfigParser"]


def _step_into(node: Any, key: str) -> Any:
    """One key of an id: a dict's key or a list's index."""
    if isinstance(node, dict):
        return node[key]
    if isinstance(node, list):
        try:
            return node[int(key)]
        except ValueError as e:
            raise KeyError(f"list index expected at `{key}`") from e
    raise ValueError(f"cannot descend into {type(node).__name__} at `{key}`: {node!r}")


class ConfigParser:
    """A config tree, its items and their resolved values."""

    suffixes = ("json", "yaml", "yml")
    suffix_match = rf".*\.({'|'.join(suffixes)})"
    path_match = rf"({suffix_match}$)"
    meta_key = "_meta_"
    relative_id_prefix = re.compile(rf"(?:{ID_REF_KEY}|{MACRO_KEY})(?:{ID_SEP_KEY})+")

    _DEFAULT_GLOBALS = {"json": "json", "re": "re", "np": "numpy", "numpy": "numpy", "torch": "torch",
                        "monai_tpu_torch": "monai_tpu_torch", "monai": "monai_tpu_torch"}

    def __init__(self, config: Any = None, excludes: Sequence[str] | str | None = None,
                 globals: dict[str, Any] | bool | None = None):
        self.config: Any = None
        self.globals: dict[str, Any] = {}
        if globals is not False:
            for name, target in {**self._DEFAULT_GLOBALS, **(globals or {})}.items():
                self.globals[name] = optional_import(target)[0] if isinstance(target, str) else target
        self.locator = ComponentLocator(excludes=excludes)
        self.ref_resolver = ReferenceResolver()
        self.set(config=config if config is not None else {self.meta_key: {}})

    def __repr__(self) -> str:
        return f"{self.config}"

    def __getattr__(self, id):
        if id in {"config", "globals", "locator", "ref_resolver"}:
            raise AttributeError(id)
        return self.get_parsed_content(id)

    def __getitem__(self, id: str | int):
        node = self.config
        if id == "":
            return node
        for key in ReferenceResolver.split_id(id):
            node = _step_into(node, key)
        return node

    def __setitem__(self, id: str | int, config: Any) -> None:
        if id == "":
            self.config = config
        else:
            *parents, leaf = ReferenceResolver.split_id(id)
            target = self[ID_SEP_KEY.join(parents)]
            if isinstance(target, list):
                target[int(leaf)] = config
            else:
                target[leaf] = config
        self.ref_resolver.reset()

    def get(self, id: str = "", default: Any = None):
        try:
            return self[id]
        except (KeyError, IndexError, ValueError):
            return default

    def set(self, config: Any, id: str = "", recursive: bool = True) -> None:
        """``config`` at ``id``; with ``recursive``, missing dicts along the id are made."""
        if recursive:
            if self.config is None:
                self.config = {}
            node = self.config
            for step in ReferenceResolver.split_id(id)[:-1]:
                node = node.setdefault(step, {}) if isinstance(node, dict) else node[int(step)]
        self[id] = config

    def update(self, pairs: dict) -> None:
        """Set each ``id: value`` of ``pairs`` (how a run's overrides are applied)."""
        for key, value in pairs.items():
            self[key] = value

    def __contains__(self, id: str | int) -> bool:
        sentinel = object()
        return self.get(id, sentinel) is not sentinel

    def parse(self, reset: bool = True) -> None:
        """Expand the macros and relative ids, then make the items."""
        if reset:
            self.ref_resolver.reset()
        self.resolve_macro_and_relative_ids()
        self._do_parse(config=self.get())

    def get_parsed_content(self, id: str = "", **kwargs):
        """The resolved value at ``id``: instantiated, evaluated, references followed.
        Parses first where nothing is resolved yet, or where ``lazy=False``."""
        if not self.ref_resolver.is_resolved() or not kwargs.get("lazy", True):
            self.parse(reset=True)
        return self.ref_resolver.get_resolved_content(id=id, **kwargs)

    def read_meta(self, f, **kwargs) -> None:
        self.set(self.load_config_files(f, **kwargs), self.meta_key)

    def read_config(self, f, **kwargs) -> None:
        self.set(config={self.meta_key: self.get(self.meta_key, {}), **self.load_config_files(f, **kwargs)})

    def _do_resolve(self, config: Any, id: str = ""):
        if isinstance(config, (dict, list)):
            for k, sub_id, v in self.ref_resolver.iter_subconfigs(id, config):
                config[k] = self._do_resolve(v, sub_id)
        if isinstance(config, str):
            config = self.resolve_relative_ids(id, config)
            if config.startswith(MACRO_KEY):
                path, macro_id = self.split_path_id(config[len(MACRO_KEY):])
                source = ConfigParser(ConfigParser.load_config_file(path)) if path else self
                return deepcopy(source[macro_id])
        return config

    def resolve_macro_and_relative_ids(self) -> None:
        self.set(self._do_resolve(config=deepcopy(self.get())))

    def _do_parse(self, config: Any, id: str = "") -> None:
        """Children first, then this node as a component, an expression or plain."""
        if isinstance(config, (dict, list)):
            for _, sub_id, v in self.ref_resolver.iter_subconfigs(id, config):
                self._do_parse(config=v, id=sub_id)
        if ConfigComponent.is_instantiable(config):
            item: ConfigItem = ConfigComponent(config=config, id=id, locator=self.locator)
        elif ConfigExpression.is_expression(config):
            item = ConfigExpression(config=config, id=id, globals=self.globals)
        else:
            item = ConfigItem(config=config, id=id)
        self.ref_resolver.add_item(item)

    @classmethod
    def load_config_file(cls, filepath, **kwargs):
        """One JSON or YAML file."""
        if not filepath:
            return {}
        path = str(Path(filepath))
        if not re.compile(cls.path_match, re.IGNORECASE).findall(path):
            raise ValueError(f'unknown file input: "{filepath}"')
        with open(path) as f:
            if path.lower().endswith(cls.suffixes[0]):
                return json.load(f, **kwargs)
            import yaml

            return yaml.safe_load(f, **kwargs)

    @classmethod
    def load_config_files(cls, files, **kwargs) -> dict:
        """One or more files or dicts, merged in order."""
        if isinstance(files, dict):
            return files
        merged = ConfigParser(config={})
        for entry in ensure_tuple(files):
            merged.update(entry if isinstance(entry, dict) else cls.load_config_file(entry, **kwargs))
        return merged.get()

    @classmethod
    def export_config_file(cls, config: dict, filepath: str, fmt: str = "json", **kwargs) -> None:
        """Write ``config`` to ``filepath`` as JSON or YAML (``fmt``); ``kwargs`` go to
        ``json.dump`` or ``yaml.safe_dump``."""
        writer = fmt.lower()
        if writer not in ("json", "yaml", "yml"):
            raise ValueError(f"only support JSON or YAML config file so far, got {writer}.")
        with open(str(Path(filepath)), "w") as f:
            if writer == "json":
                json.dump(config, f, **kwargs)
            else:
                import yaml

                yaml.safe_dump(config, f, **kwargs)

    @classmethod
    def split_path_id(cls, src: str) -> tuple[str, str]:
        """``"file.json::a::b"`` as ``("file.json", "a::b")``; an id alone as ``("", id)``."""
        src = ReferenceResolver.normalize_id(src)
        hits = re.compile(rf"({cls.suffix_match}(?={ID_SEP_KEY}))").findall(src)
        if not hits:
            return "", src
        fname = hits[0][0]
        tail = src.rsplit(fname, 1)[1]
        return fname, tail[len(ID_SEP_KEY):] if tail.startswith(ID_SEP_KEY) else ""

    @classmethod
    def resolve_relative_ids(cls, id: str, value: str) -> str:
        """``@::x`` and ``%::x`` (one ``::`` a level up from ``id``) as absolute ids."""
        anchor = id.split(ID_SEP_KEY)
        # longest prefixes first, so that `@::::x` is rewritten before `@::x`
        for prefix in sorted(set(cls.relative_id_prefix.findall(value)), reverse=True):
            sym = ID_REF_KEY if ID_REF_KEY in prefix else MACRO_KEY
            up = prefix[len(sym):].count(ID_SEP_KEY)
            if up > len(anchor):
                raise ValueError(f"the relative id in `{value}` is out of the range of config content.")
            absolute = "" if up == len(anchor) else ID_SEP_KEY.join(anchor[:-up]) + ID_SEP_KEY
            value = value.replace(prefix, sym + absolute)
        return value
