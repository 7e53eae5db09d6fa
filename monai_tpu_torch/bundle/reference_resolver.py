"""Resolution of ``@`` references between config items, in dependency order
(counterpart of monai_tpu/bundle/reference_resolver.py).

An item resolves after everything it depends on: the ids its strings reference and its
nested components and expressions, which resolve bottom-up. A reference inside a ``$``
expression becomes a lookup in a dict of resolved values that the expression sees as a
global; a string that is exactly ``@id`` becomes the value itself. Import expressions
run once, before anything else resolves. A reference cycle raises.
"""
from __future__ import annotations

import re
import warnings
from collections.abc import Sequence
from typing import Any

from .config_item import ConfigComponent, ConfigExpression, ConfigItem
from .utils import ID_REF_KEY, ID_SEP_KEY

__all__ = ["ReferenceResolver"]


def _nested(node: Any) -> bool:
    return ConfigComponent.is_instantiable(node) or ConfigExpression.is_expression(node)


class ReferenceResolver:
    """The config's items by id, and their resolved values."""

    _vars = "__local_refs"
    sep = ID_SEP_KEY
    ref = ID_REF_KEY
    id_matcher = re.compile(rf"{ref}(?:\w*)(?:{sep}\w*)*")
    allow_missing_reference = False

    def __init__(self, items: Sequence[ConfigItem] | None = None):
        self.items: dict[str, ConfigItem] = {} if items is None else {i.get_id(): i for i in items}
        self.resolved_content: dict[str, Any] = {}
        self._imports_done = False

    def reset(self) -> None:
        self.items, self.resolved_content, self._imports_done = {}, {}, False

    def is_resolved(self) -> bool:
        return bool(self.resolved_content)

    def add_item(self, item: ConfigItem) -> None:
        self.items.setdefault(item.get_id(), item)

    def get_resolved_content(self, id: str, **kwargs):
        return self._resolve(self.normalize_id(id), set(), **kwargs)

    @classmethod
    def normalize_id(cls, id: str | int) -> str:
        """``#`` separators as ``::``."""
        return str(id).replace("#", cls.sep)

    @classmethod
    def split_id(cls, id: str | int, last: bool = False) -> list[str]:
        norm = cls.normalize_id(id)
        if not last:
            return norm.split(cls.sep)
        head, _, tail = norm.rpartition(cls.sep)
        return [head, tail]

    @classmethod
    def iter_subconfigs(cls, id: str, config: Any):
        """(key, sub id, sub config) of each child of a dict or list."""
        pairs = config.items() if isinstance(config, dict) else enumerate(config)
        for k, v in pairs:
            yield k, (f"{id}{cls.sep}{k}" if id else f"{k}"), v

    @classmethod
    def _refs_in_string(cls, value: str) -> list[str]:
        """Every ``@id`` of a ``$`` expression; the id of a string that is one ``@id``."""
        value = cls.normalize_id(value)
        hits = cls.id_matcher.findall(value)
        if not ConfigExpression.is_expression(value):
            hits = [h for h in hits if h == value]
        return [h[len(cls.ref):] for h in hits]

    @classmethod
    def find_refs_in_config(cls, config: Any, id: str, refs: dict[str, int] | None = None) -> dict[str, int]:
        """``refs`` plus every id ``config`` depends on: its references and its nested
        components and expressions."""
        found = dict(refs or {})

        def walk(node: Any, node_id: str) -> None:
            if isinstance(node, str):
                for r in cls._refs_in_string(node):
                    found[r] = found.get(r, 0) + 1
            elif isinstance(node, (list, dict)):
                for _, sub_id, child in cls.iter_subconfigs(node_id, node):
                    if _nested(child) and sub_id not in found:
                        found[sub_id] = 1
                    walk(child, sub_id)

        walk(config, id)
        return found

    @classmethod
    def update_refs_pattern(cls, value: str, refs: dict) -> Any:
        """``value`` with its references replaced by their resolved values."""
        value = cls.normalize_id(value)
        if ConfigExpression.is_expression(value):
            # longest ids first, so that `@a::b` is not clobbered by `@a`
            for hit in sorted(set(cls.id_matcher.findall(value)), key=len, reverse=True):
                rid = hit[len(cls.ref):]
                if rid in refs:
                    value = value.replace(hit, f"{cls._vars}['{rid}']")
            return value
        if value.startswith(cls.ref) and cls.id_matcher.fullmatch(value):
            rid = value[len(cls.ref):]
            if rid in refs:
                return refs[rid]
            msg = f"can not find expected ID '{rid}' in the references."
            if not cls.allow_missing_reference:
                raise KeyError(msg)
            warnings.warn(msg)
        return value

    @classmethod
    def update_config_with_refs(cls, config: Any, id: str, refs: dict | None = None):
        """``config`` with its references and nested items replaced by their resolved
        values; a disabled nested component (resolved to None) is left out."""
        refs = refs or {}

        def rebuild(node: Any, node_id: str) -> Any:
            if isinstance(node, str):
                return cls.update_refs_pattern(node, refs)
            if not isinstance(node, (list, dict)):
                return node
            out: dict | list = {} if isinstance(node, dict) else []
            for key, sub_id, child in cls.iter_subconfigs(node_id, node):
                if _nested(child):
                    new = refs[sub_id]
                    if new is None and ConfigComponent.is_instantiable(child):
                        continue
                else:
                    new = rebuild(child, sub_id)
                if isinstance(out, dict):
                    out[key] = new
                else:
                    out.append(new)
            return out

        return rebuild(config, id)

    def _hoist_imports(self, **kwargs) -> None:
        """Run every import expression once, so that later expressions see the names."""
        if self._imports_done:
            return
        self._imports_done = True
        for iid, item in self.items.items():
            if iid not in self.resolved_content and isinstance(item, ConfigExpression) \
                    and item.is_import_statement(item.get_config()):
                self.resolved_content[iid] = item.evaluate() if kwargs.get("eval_expr", True) else item

    def _resolve(self, id: str, in_progress: set[str], **kwargs):
        if id in self.resolved_content:
            return self.resolved_content[id]
        item = self.items.get(id)
        if item is None:
            msg = f"id='{id}' is not found in the config resolver."
            if not self.allow_missing_reference:
                raise KeyError(msg)
            warnings.warn(msg)
            return None
        in_progress.add(id)
        self._hoist_imports(**kwargs)
        config = item.get_config()
        for dep in self.find_refs_in_config(config, id):
            if dep in in_progress:
                raise ValueError(f"detected circular references '{dep}' for id='{id}' in the config content.")
            if dep in self.resolved_content:
                continue
            if dep not in self.items:
                msg = f"the referring item `@{dep}` is not defined in the config content."
                if not self.allow_missing_reference:
                    raise ValueError(msg)
                warnings.warn(msg)
                continue
            self._resolve(dep, in_progress, **kwargs)
        in_progress.discard(id)

        item.update_config(config=self.update_config_with_refs(config, id, self.resolved_content))
        if isinstance(item, ConfigComponent):
            value = item.instantiate() if kwargs.get("instantiate", True) else item
        elif isinstance(item, ConfigExpression):
            value = item.evaluate(globals={self._vars: self.resolved_content}) if kwargs.get("eval_expr", True) \
                else item
        else:
            value = item.get_config()
        self.resolved_content[id] = value
        return value
