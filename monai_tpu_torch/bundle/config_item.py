"""Config items: the nodes of a bundle config that instantiate a component or evaluate
an expression (counterpart of monai_tpu/bundle/config_item.py).

``ConfigComponent`` is a dict with ``_target_`` (and optionally ``_disabled_``,
``_requires_``, ``_desc_``, ``_mode_``); ``ConfigExpression`` is a string that starts
with ``$``. ``ComponentLocator`` maps a bare ``_target_`` such as ``"UNet"`` to the
module of ``monai_tpu_torch`` that defines it: its scan imports every module of the port
(each imports without a card), and a name counts where the module defines it, not
where it is re-exported, so a class is found once.
"""
from __future__ import annotations

import ast
import importlib
import inspect
import pkgutil
import warnings
from abc import ABC, abstractmethod
from collections.abc import Mapping, Sequence
from typing import Any

from ..utils.enums import CompInitMode
from ..utils.misc import ensure_tuple
from ..utils.module import instantiate, optional_import
from .utils import EXPR_KEY

__all__ = ["ComponentLocator", "ConfigComponent", "ConfigExpression", "ConfigItem", "Instantiable"]


class Instantiable(ABC):
    """A config component that can be disabled or instantiated."""

    @abstractmethod
    def is_disabled(self, *args, **kwargs) -> bool:
        raise NotImplementedError

    @abstractmethod
    def instantiate(self, *args, **kwargs):
        raise NotImplementedError


class ComponentLocator:
    """Names of classes and functions to the modules of ``MOD_START`` that define them."""

    MOD_START = "monai_tpu_torch"

    def __init__(self, excludes: Sequence[str] | str | None = None):
        self.excludes = () if excludes is None else ensure_tuple(excludes)
        self._table: dict[str, list[str]] | None = None

    def _scan(self) -> dict[str, list[str]]:
        root = importlib.import_module(self.MOD_START)
        table: dict[str, list[str]] = {}
        for info in pkgutil.walk_packages(root.__path__, prefix=f"{root.__name__}."):
            if info.name.endswith(".__main__") or any(ex in info.name for ex in self.excludes):
                continue
            try:
                module = importlib.import_module(info.name)
            except Exception as e:  # a module that cannot import here cannot be a target either
                warnings.warn(f"ComponentLocator: skipping {info.name}: {e}")
                continue
            for name, obj in vars(module).items():
                if (inspect.isclass(obj) or inspect.isfunction(obj)) and obj.__module__ == info.name:
                    table.setdefault(name, []).append(info.name)
        return table

    def get_component_module_name(self, name: str) -> list[str] | str | None:
        """The module that defines ``name``; a list where several do; None where none."""
        if not isinstance(name, str):
            raise ValueError(f"`name` must be a valid string, but got: {name}.")
        if self._table is None:
            self._table = self._scan()
        homes = self._table.get(name)
        return homes[0] if homes is not None and len(homes) == 1 else homes


class ConfigItem:
    """A node of the config and its id (``"network::channels"``)."""

    def __init__(self, config: Any, id: str = ""):
        self.config = config
        self.id = id

    def get_id(self) -> str:
        return self.id

    def update_config(self, config: Any) -> None:
        self.config = config

    def get_config(self):
        return self.config

    def __repr__(self) -> str:
        return f"{type(self).__name__}: \n{self.config!r}"


class ConfigComponent(ConfigItem, Instantiable):
    """A ``_target_`` dict: the other keys are the target's arguments."""

    non_arg_keys = {"_target_", "_disabled_", "_requires_", "_desc_", "_mode_"}

    def __init__(self, config: Any, id: str = "", locator: ComponentLocator | None = None,
                 excludes: Sequence[str] | str | None = None):
        super().__init__(config=config, id=id)
        self.locator = locator if locator is not None else ComponentLocator(excludes=excludes)

    @staticmethod
    def is_instantiable(config: Any) -> bool:
        return isinstance(config, Mapping) and "_target_" in config

    def resolve_module_name(self):
        """A bare name's full dotted path; a dotted path or an object as it is."""
        target = self.get_config().get("_target_")
        if not isinstance(target, str):
            return target
        homes = self.locator.get_component_module_name(target)
        if homes is None:
            return target
        if isinstance(homes, list):
            warnings.warn(f"there are more than 1 component have name `{target}`: {homes}, use the first one "
                          f"`{homes[0]}`. if want to use others, please set its full module path in `_target_`.")
            homes = homes[0]
        return f"{homes}.{target}"

    def resolve_args(self) -> dict:
        return {k: v for k, v in self.get_config().items() if k not in self.non_arg_keys}

    def is_disabled(self) -> bool:
        flag = self.get_config().get("_disabled_", False)
        return flag.strip().lower() == "true" if isinstance(flag, str) else bool(flag)

    def instantiate(self, **kwargs):
        """The target called with its arguments and ``kwargs``; None where disabled."""
        if not self.is_instantiable(self.get_config()) or self.is_disabled():
            return None
        mode = self.get_config().get("_mode_", CompInitMode.DEFAULT)
        return instantiate(self.resolve_module_name(), mode, **(self.resolve_args() | kwargs))


def _import_node(code: str) -> ast.Import | ast.ImportFrom | None:
    """The first statement of ``code`` where it is an import, else None."""
    try:
        body = ast.parse(code).body
    except SyntaxError:
        return None
    return body[0] if body and isinstance(body[0], (ast.Import, ast.ImportFrom)) else None


class ConfigExpression(ConfigItem):
    """A ``$`` string: a Python expression, or an import that binds a name into
    ``globals`` for the expressions after it."""

    prefix = EXPR_KEY
    run_eval = True

    def __init__(self, config: Any, id: str = "", globals: dict | None = None):
        super().__init__(config=config, id=id)
        self.globals = globals if globals is not None else {}

    def _do_import(self, node: ast.Import | ast.ImportFrom):
        if len(node.names) > 1:
            warnings.warn(f"ignoring multiple import alias '{self.get_config()}'.")
        alias = node.names[0]
        if isinstance(node, ast.ImportFrom):
            value, _ = optional_import(node.module, name=alias.name)
        else:
            value, _ = optional_import(alias.name)
        self.globals[alias.asname or alias.name] = value
        return value

    def evaluate(self, globals: dict | None = None, locals: dict | None = None):
        value = self.get_config()
        if not self.is_expression(value):
            return None
        code = value[len(self.prefix):]
        node = _import_node(code)
        if node is not None:
            return self._do_import(node)
        if not self.run_eval:
            return code
        scope = dict(self.globals)
        for k, v in (globals or {}).items():
            if k in scope:
                warnings.warn(f"the new global variable `{k}` conflicts with `self.globals`, override it.")
            scope[k] = v
        return eval(code, scope, locals)

    @classmethod
    def is_expression(cls, config: Any) -> bool:
        return isinstance(config, str) and config.startswith(cls.prefix)

    @classmethod
    def is_import_statement(cls, config: Any) -> bool:
        return cls.is_expression(config) and "import" in config and \
            _import_node(config[len(cls.prefix):]) is not None
