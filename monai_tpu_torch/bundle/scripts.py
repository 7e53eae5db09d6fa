"""The bundle runner's verbs (counterpart of monai_tpu/bundle/scripts.py: ``run`` and
``update_kwargs``)."""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

from .config_parser import ConfigParser
from .workflows import ConfigWorkflow

__all__ = ["run", "update_kwargs"]


def update_kwargs(args: str | dict | None = None, ignore_none: bool = True, **kwargs) -> dict:
    """``args`` (a dict, or a JSON or YAML file of one) updated with ``kwargs``; with
    ``ignore_none``, kwargs that are None are left out."""
    merged = dict(ConfigParser.load_config_file(args)) if isinstance(args, str) else dict(args or {})
    merged.update({k: v for k, v in kwargs.items() if not (ignore_none and v is None)})
    return merged


def run(run_id: str | None = None, init_id: str | None = None, final_id: str | None = None,
        meta_file: str | Sequence[str] | None = None, config_file: str | Sequence[str] | None = None,
        logging_file: str | None = None, tracking: str | dict | None = None, args_file: str | None = None,
        **override: Any) -> list:
    """Run a bundle config: ``python -m monai_tpu_torch.bundle run --config_file
    inference.json --bundle_root <dir> [--<id> <value> ...]``. Every keyword that is not
    one of the named arguments overrides the config item of that id (``::`` separates
    its keys), as ``ConfigWorkflow`` applies them. Returns what the run items return."""
    _args = update_kwargs(args=args_file, run_id=run_id, init_id=init_id, final_id=final_id, meta_file=meta_file,
                          config_file=config_file, logging_file=logging_file, tracking=tracking, **override)
    if "config_file" not in _args:
        raise ValueError("`config_file` is required for `run`.")
    _args.pop("tracking", None)
    workflow = ConfigWorkflow(config_file=_args.pop("config_file"), meta_file=_args.pop("meta_file", None),
                              logging_file=_args.pop("logging_file", None),
                              init_id=_args.pop("init_id", None) or "initialize",
                              run_id=_args.pop("run_id", None) or "run",
                              final_id=_args.pop("final_id", None) or "finalize", workflow_type=None, **_args)
    workflow.initialize()
    ret = workflow.run()
    workflow.finalize()
    return ret
