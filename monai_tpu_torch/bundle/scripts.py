"""The bundle runner's verbs (counterpart of monai_tpu/bundle/scripts.py): ``run``,
``run_workflow``, ``verify_metadata``, ``verify_net_in_out``, ``ckpt_export`` with
``load_exported_network``, ``init_bundle``, ``create_workflow``, ``download``, ``load`` and
``update_kwargs``.

``ckpt_export`` writes what the JAX package's does, in torch's forms: the weights (a torch
file, ``{"model": state_dict}``, where the JAX package writes an orbax directory), the
config as JSON, and the network's forward as a ``torch.export`` program where the JAX
package writes StableHLO. The program calls the port's kernels as torch operators, each
the inference forward of a kernel with a fake version for the tracer and no backward:
``torch.ops.monai_tpu_torch.conv3d_3x3_same`` (kernel 1), ``instance_norm_prelu`` (the
instance norm, B2) and ``fused_window_attention`` (kernel 2). Importing ``monai_tpu_torch``
registers them, so replaying a program needs the package imported, where the JAX artifact
replays without the model's code. A failed export raises: there is no artifact without its
program.
"""
from __future__ import annotations

import json
import os
import warnings
from collections.abc import Sequence
from pathlib import Path
from typing import Any

import torch

from ..utils.backend import full_float32
from ..utils.module import locate, optional_import
from .config_parser import ConfigParser
from .workflows import BundleWorkflow, ConfigWorkflow

__all__ = ["ckpt_export", "create_workflow", "download", "init_bundle", "load", "load_exported_network", "run",
           "run_workflow", "update_kwargs", "verify_metadata", "verify_net_in_out"]

REQUIRED_METADATA = ("version", "monai_version", "numpy_version")


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


def _workflow_class(name) -> type:
    """``ConfigWorkflow`` for None; a class of this package or a dotted path for a name;
    a ``BundleWorkflow`` subclass as it is."""
    if name is None:
        return ConfigWorkflow
    if isinstance(name, str):
        from .. import bundle

        try:
            cls = getattr(bundle, name, None) or locate(name)
        except ModuleNotFoundError:
            cls = None
        if cls is None:
            raise ValueError(f"cannot locate specified workflow class: {name}.")
        return cls
    if isinstance(name, type) and issubclass(name, BundleWorkflow):
        return name
    raise ValueError(f"Argument `workflow_name` must be a bundle workflow class name or subclass of BundleWorkflow, "
                     f"got: {name}.")


def run_workflow(workflow_name: str | type | None = None, config_file: str | Sequence[str] | None = None,
                 args_file: str | None = None, **kwargs) -> BundleWorkflow:
    """Make the workflow ``workflow_name`` (a class, its name or dotted path; default
    ``ConfigWorkflow``) from ``config_file`` and the keywords, then initialize, run and
    finalize it; returns it. ``python -m monai_tpu_torch.bundle run_workflow --config_file
    train.json --workflow_type train ...``."""
    _args = update_kwargs(args=args_file, workflow_name=workflow_name, config_file=config_file, **kwargs)
    workflow = _workflow_class(_args.pop("workflow_name", None))(**_args)
    workflow.initialize()
    workflow.run()
    workflow.finalize()
    return workflow


def create_workflow(workflow_name: str | type | None = None, config_file: str | Sequence[str] | None = None,
                    args_file: str | None = None, **kwargs) -> BundleWorkflow:
    """Make and initialize (not run) the workflow ``workflow_name``, as ``run_workflow``."""
    _args = update_kwargs(args=args_file, workflow_name=workflow_name, config_file=config_file, **kwargs)
    cls = _workflow_class(_args.pop("workflow_name", None))
    config_file = _args.pop("config_file", None)
    workflow = cls(config_file=config_file, **_args) if config_file is not None else cls(**_args)
    workflow.initialize()
    return workflow


def verify_metadata(meta_file: str | Sequence[str] | None = None, filepath: str | None = None,
                    create_dir: bool | None = None, hash_val: str | None = None, args_file: str | None = None,
                    **kwargs) -> bool:
    """Verify a bundle's metadata: against the JSON schema at ``filepath`` where that file
    exists and ``jsonschema`` can be imported, else (with a warning where ``jsonschema`` is
    missing) for the keys every metadata must have, ``version``, ``monai_version`` and
    ``numpy_version``; raises where they are missing. Nothing is downloaded."""
    _args = update_kwargs(args=args_file, meta_file=meta_file, filepath=filepath, **kwargs)
    meta = ConfigParser.load_config_files(_args["meta_file"])
    schema_path = _args.get("filepath")
    if schema_path and os.path.exists(schema_path):
        jsonschema, has_jsonschema = optional_import("jsonschema")
        if has_jsonschema:
            with open(schema_path) as f:
                jsonschema.validate(instance=meta, schema=json.load(f))
            print("metadata is verified with no error.")
            return True
        warnings.warn("jsonschema is not installed; only structural checks performed.")
    missing = [k for k in REQUIRED_METADATA if k not in meta]
    if missing:
        raise ValueError(f"metadata missing required keys: {missing}")
    print("metadata is verified with no error.")
    return True


def _parser(config_file, meta_file, override: dict) -> ConfigParser:
    parser = ConfigParser()
    parser.read_config(config_file)
    if meta_file:
        parser.read_meta(meta_file)
    parser.update(pairs=override)
    return parser


def _input_shape(parser: ConfigParser, default_side: int) -> tuple:
    """(1, channels) + spatial shape from the metadata's ``network_data_format``; a
    spatial size that is not a number ("*") is ``default_side``."""
    info = parser.get(parser.meta_key, {}).get("network_data_format", {}).get("inputs", {}).get("image", {})
    spatial = tuple(s if isinstance(s, int) else default_side
                    for s in info.get("spatial_shape", (default_side,) * 3))
    return (1, len(info.get("channel_def", {"0": "image"}))) + spatial


def verify_net_in_out(net_id: str | None = None, meta_file=None, config_file=None, device=None, p: int | None = None,
                      n: int | None = None, any: int | None = None, extra_forward_args: dict | None = None,
                      args_file: str | None = None, **override) -> torch.nn.Module:
    """Run the bundle's network (``net_id``, default ``network_def``) once on a random
    input of the metadata's shape (a "*" size is 32) and check its output channels against
    the metadata's ``pred`` (default 2); returns the network. The input is made on the
    network's device, or the network moves to ``device`` where that is given. The other
    keywords override config items, as in ``run``."""
    _args = update_kwargs(args=args_file, net_id=net_id, meta_file=meta_file, config_file=config_file, **override)
    names = ("net_id", "meta_file", "config_file")
    parser = _parser(_args["config_file"], _args.get("meta_file"), {k: v for k, v in _args.items() if k not in names})
    net = parser.get_parsed_content(_args.get("net_id") or "network_def")
    if device is not None:
        net = net.to(device)
    output_info = parser.get(parser.meta_key, {}).get("network_data_format", {}).get("outputs", {}).get("pred", {})
    output_channels = len(output_info.get("channel_def", {"0": "bg", "1": "fg"}))
    param = next(net.parameters())
    x = torch.rand(_input_shape(parser, 32), generator=torch.Generator().manual_seed(0)).to(param.device)
    with torch.no_grad():
        y = net.eval()(x, **(extra_forward_args or {}))
    if y.shape[1] != output_channels:
        raise ValueError(f"output channel number `{y.shape[1]}` doesn't match: `{output_channels}`.")
    print("data shape of network is verified with no error.")
    return net


def _load_weights(net: torch.nn.Module, ckpt_file: str, key: str) -> None:
    """Load ``ckpt_file`` (``{key: state_dict}`` or a bare state dict) into ``net``, every
    key matched."""
    checkpoint = torch.load(ckpt_file, map_location=next(net.parameters()).device, weights_only=True)
    net.load_state_dict(checkpoint[key] if key in checkpoint else checkpoint)


def ckpt_export(net_id: str | None = None, filepath: str | None = None, ckpt_file: str | None = None,
                meta_file=None, config_file=None, key_in_ckpt: str | None = None, input_shape=None,
                args_file: str | None = None, **override) -> str:
    """Export a bundle's network (``net_id``, default ``network_def``) with the weights of
    ``ckpt_file`` (its ``key_in_ckpt`` entry, default ``model``) into the directory
    ``filepath``: ``model.pt`` (``{"model": state_dict}``), ``config.json`` (the config
    as parsed from its files, overrides applied), ``model.pt2`` (``torch.export`` of the
    eval-mode forward on a float32 input of ``input_shape``, default the metadata's with
    "*" as 96, on the network's device) and ``export_meta.json``. Returns the directory.
    ``python -m monai_tpu_torch.bundle ckpt_export --net_id network --filepath <dir>
    --ckpt_file <file> --config_file inference.json``."""
    _args = update_kwargs(args=args_file, net_id=net_id, filepath=filepath, ckpt_file=ckpt_file, meta_file=meta_file,
                          config_file=config_file, key_in_ckpt=key_in_ckpt, input_shape=input_shape, **override)
    names = ("net_id", "filepath", "ckpt_file", "meta_file", "config_file", "key_in_ckpt", "input_shape")
    parser = _parser(_args["config_file"], _args.get("meta_file"), {k: v for k, v in _args.items() if k not in names})
    net = parser.get_parsed_content(_args.get("net_id") or "network_def")
    if _args.get("ckpt_file"):
        _load_weights(net, _args["ckpt_file"], _args.get("key_in_ckpt") or "model")
    out = Path(_args["filepath"])
    out.mkdir(parents=True, exist_ok=True)
    from ..handlers.checkpoint import save_checkpoint

    save_checkpoint({"model": net}, str(out / "model.pt"))
    ConfigParser.export_config_file(parser.get(), str(out / "config.json"), fmt="json", indent=2)
    shape = tuple(_args.get("input_shape") or _input_shape(parser, 96))
    x = torch.zeros(shape, dtype=torch.float32, device=next(net.parameters()).device)
    with torch.no_grad():
        program = torch.export.export(net.eval(), (x,), strict=False)
    torch.export.save(program, str(out / "model.pt2"))
    (out / "export_meta.json").write_text(json.dumps({"input_shape": list(shape), "dtype": "float32",
                                                      "device": str(x.device), "format": "torch.export"}, indent=2))
    print(f"exported bundle to {out}")
    return str(out)


def load_exported_network(filepath: str):
    """The ``model.pt2`` program of ``ckpt_export`` as a callable of one input, run
    without autograd. Its float32 cuDNN convolutions run in full float32
    (``full_float32``), as the network's own forward runs them, and its kernels through
    the operators ``torch.ops.monai_tpu_torch.conv3d_3x3_same``, ``instance_norm_prelu``
    and ``fused_window_attention``, which importing ``monai_tpu_torch`` (as this module
    does) registers; ``torch.export.load`` replays the file likewise once the package is
    imported."""
    module = torch.export.load(str(filepath)).module()

    def run(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_float32(x):
            return module(x)

    return run


def init_bundle(bundle_dir: str, ckpt_file=None, network=None, dataset_license: bool = False, metadata_str=None,
                inference_str=None) -> str:
    """Make a bundle's skeleton under ``bundle_dir``: ``configs/metadata.json``,
    ``configs/inference.json`` and ``docs/README.md``, and an empty ``models/``."""
    bundle_path = Path(bundle_dir)
    for d in ("configs", "models", "docs"):
        (bundle_path / d).mkdir(parents=True, exist_ok=True)
    metadata = metadata_str or {
        "version": "0.0.1", "changelog": {"0.0.1": "Initial version"}, "monai_version": "0.1.0",
        "pytorch_version": torch.__version__, "numpy_version": "1.26.0", "required_packages_version": {},
        "task": "Describe what the network predicts", "description": "A longer description of what the network does",
        "authors": "Your Name Here", "copyright": "Copyright (c) Your Name Here",
        "network_data_format": {"inputs": {}, "outputs": {}},
    }
    inference = inference_str or {
        "imports": ["$import glob"], "device": "$None", "ckpt_path": "$@bundle_root + '/models/model.pt'",
        "network_def": {"_target_": "???", "spatial_dims": 3},
        "preprocessing": {"_target_": "Compose", "transforms": []},
        "postprocessing": {"_target_": "Compose", "transforms": []}, "inferer": {"_target_": "SimpleInferer"},
    }
    with open(bundle_path / "configs" / "metadata.json", "w") as f:
        json.dump(metadata, f, indent=2)
    with open(bundle_path / "configs" / "inference.json", "w") as f:
        json.dump(inference, f, indent=2)
    (bundle_path / "docs" / "README.md").write_text("# Your Model Name\n\nDescribe your model here and how to run it.\n")
    return str(bundle_path)


def download(name: str | None = None, version: str | None = None, bundle_dir: str | None = None,
             source: str = "github", repo: str | None = None, url: str | None = None, **kwargs) -> str:
    """Only a bundle already on disk: ``url`` as it is where that path exists; anything
    else raises, as nothing is downloaded."""
    if url and os.path.exists(url):
        return url
    raise RuntimeError("network downloads are unavailable in this environment; place the bundle locally and pass "
                       "`url=<local path>`.")


def load(name: str, version: str | None = None, bundle_dir: str | None = None, **kwargs) -> torch.nn.Module:
    """The network of the local bundle ``<bundle_dir>/<name>`` (its
    ``configs/inference.json``'s ``network_def``, the keywords overriding config items),
    with the weights of its ``models/model.pt`` where that file exists."""
    root = Path(bundle_dir or ".") / name
    config = root / "configs" / "inference.json"
    if not config.exists():
        raise FileNotFoundError(f"bundle config not found: {config}")
    net = _parser(str(config), None, kwargs).get_parsed_content("network_def")
    if (root / "models" / "model.pt").exists():
        _load_weights(net, str(root / "models" / "model.pt"), "model")
    return net
