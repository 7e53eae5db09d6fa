"""The port's bundle runner (monai_tpu_torch.bundle) against monai_tpu's, on the CPU.

The Spleen bundle's own ``inference.json`` is read by both packages' ``ConfigParser``
with the same overrides (``bundle_root``, and ``imports`` and ``initialize`` naming each
package); every id of the config becomes the same kind of item in both, every plain
value and expression resolves to the same value (references followed, the checkpoint's
``_disabled_`` the same), and every ``_target_`` resolves to a class of the port with
the JAX class's name, never into ``monai_tpu``. The port then instantiates every
component on the CPU (``device="cpu"`` overrides). The command line parses its
arguments as the JAX package's does.
"""
import json
from pathlib import Path

import pytest
import torch

import monai_tpu.bundle.__main__ as jax_main
from monai_tpu.bundle import ConfigParser as JaxConfigParser
from monai_tpu.bundle.config_item import ConfigComponent as JaxConfigComponent
import monai_tpu_torch.bundle.__main__ as port_main
from monai_tpu_torch.bundle import ComponentLocator, ConfigComponent, ConfigExpression, ConfigParser, run
from monai_tpu_torch.utils import get_seed

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "bundles" / "spleen_ct_segmentation" / "configs" / "inference.json"
CPU = {"network::device": "cpu", "preprocessing::transforms::0::device": "cpu", "evaluator::device": "cpu"}


def overrides(package: str, bundle_root: str) -> dict:
    """The runner's overrides that point the bundle at a package and a root."""
    return {"bundle_root": bundle_root,
            "imports": ["$import os", "$import glob", f"$from {package}.handlers import from_engine"],
            "initialize": [f"$import {package}", f"${package}.utils.set_determinism(seed=123)"]}


def parsers(bundle_root: str):
    out = []
    for cls, package in ((JaxConfigParser, "monai_tpu"), (ConfigParser, "monai_tpu_torch")):
        parser = cls()
        parser.read_config(str(CONFIG))
        parser.update(overrides(package, bundle_root))
        parser.parse()
        out.append(parser)
    return out


@pytest.fixture
def bundle_root(tmp_path):
    images = tmp_path / "data" / "Task09_Spleen" / "imagesTs"
    images.mkdir(parents=True)
    for name in ("spleen_1.nii.gz", "spleen_0.nii.gz"):
        (images / name).write_bytes(b"")
    return str(tmp_path)


def test_overrides_name_the_package():
    over = overrides("monai_tpu_torch", "b")
    assert over["initialize"] == ["$import monai_tpu_torch", "$monai_tpu_torch.utils.set_determinism(seed=123)"]
    assert over["imports"][2] == "$from monai_tpu_torch.handlers import from_engine"


def test_every_id_resolves_as_in_jax(bundle_root, monkeypatch):
    monkeypatch.delenv("MONAI_DATA_DIRECTORY", raising=False)
    jax_parser, port_parser = parsers(bundle_root)
    jax_items, port_items = jax_parser.ref_resolver.items, port_parser.ref_resolver.items
    assert set(jax_items) == set(port_items) and len(port_items) > 60
    kinds = {ConfigComponent: JaxConfigComponent}
    for id_, item in port_items.items():
        jitem = jax_items[id_]
        assert type(item).__name__ == type(jitem).__name__, id_
        if isinstance(item, ConfigComponent):
            assert isinstance(jitem, kinds[ConfigComponent])
            path, jpath = item.resolve_module_name(), jitem.resolve_module_name()
            assert path.startswith("monai_tpu_torch.") and jpath.startswith("monai_tpu.") and \
                path.rsplit(".", 1)[1] == jpath.rsplit(".", 1)[1], (id_, path, jpath)
            assert item.is_disabled() == jitem.is_disabled(), id_
    # every value that instantiates nothing (the components' arguments too) and runs nothing
    plain = [i for i in port_items if i and not i.startswith(("run", "initialize", "imports"))
             and not _needs_a_component(port_parser, i)]
    assert len(plain) >= 80 and {"bundle_root", "ckpt_path", "dataset_dir", "datalist", "output_dir", "roi_size",
            "handlers::0::_disabled_"} <= set(plain)
    for id_ in plain:
        assert port_parser.get_parsed_content(id_) == jax_parser.get_parsed_content(id_), id_
    assert port_parser.get_parsed_content("datalist") == [
        {"image": f"{bundle_root}/data/Task09_Spleen/imagesTs/spleen_{i}.nii.gz"} for i in (0, 1)]
    assert port_parser.get_parsed_content("handlers::0::_disabled_") is True  # no checkpoint file
    assert port_parser.get_parsed_content("imports::2").__module__ == "monai_tpu_torch.handlers.ignite_metric"
    assert port_parser.get_parsed_content("initialize::1") is None and get_seed() == 123
    assert torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False


def _needs_a_component(parser, id_: str, seen=None) -> bool:
    """``id_`` is a component or resolves one on the way (a reference, a nested item)."""
    seen = set() if seen is None else seen
    item = parser.ref_resolver.items[id_]
    if isinstance(item, ConfigComponent):
        return True
    seen.add(id_)
    deps = parser.ref_resolver.find_refs_in_config(item.get_config(), id_)
    return any(d not in seen and _needs_a_component(parser, d, seen) for d in deps)


def test_port_instantiates_every_component_from_the_port(bundle_root):
    parser = ConfigParser()
    parser.read_config(str(CONFIG))
    parser.update({**overrides("monai_tpu_torch", bundle_root), **CPU})
    evaluator = parser.get_parsed_content("evaluator")
    seen = {type(v) for i, v in parser.ref_resolver.resolved_content.items()
            if isinstance(parser.ref_resolver.items[i], ConfigComponent) and v is not None}
    assert {c.__name__ for c in seen} >= {"UNet", "Compose", "LoadImaged", "Spacingd", "SaveImaged", "Invertd",
                                         "Dataset", "DataLoader", "SlidingWindowInferer", "SupervisedEvaluator"}
    assert all(c.__module__.startswith("monai_tpu_torch.") for c in seen), seen
    assert type(evaluator).__module__ == "monai_tpu_torch.engines.evaluator" and evaluator.decollate
    assert parser.get_parsed_content("handlers") == []  # the checkpoint loader is disabled without its file
    assert len(parser.get_parsed_content("dataset")) == 2 and parser.get_parsed_content("dataloader").num_workers == 0
    assert next(parser.get_parsed_content("network").parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", ["UNet", "Compose", "SlidingWindowInferer", "Dataset", "SaveImaged",
                                  "CheckpointLoader", "SupervisedEvaluator"])
def test_locator_finds_one_home_in_the_port(name):
    home = ComponentLocator().get_component_module_name(name)
    assert isinstance(home, str) and home.startswith("monai_tpu_torch."), home


def test_locator_never_resolves_into_monai_tpu():
    table = ComponentLocator()._scan()
    assert not any(m == "monai_tpu" or m.startswith("monai_tpu.") for homes in table.values() for m in homes)
    assert not [n for n, homes in table.items() if len(homes) > 1 and not n.startswith("_")]


def test_expressions_see_the_port_and_import_it():
    parser = ConfigParser({"a": "$torch.zeros(2).sum().item()", "b": "$monai.utils.ensure_tuple(3)",
                           "c": "$import monai_tpu_torch", "d": "$monai_tpu_torch.__name__", "e": "@a",
                           "f": {"_target_": "monai_tpu_torch.utils.ensure_tuple", "vals": "@e", "_mode_": "default"},
                           "g": {"_target_": "ensure_tuple", "vals": 1, "_mode_": "partial"}})
    assert parser.get_parsed_content("a") == 0.0 and parser.get_parsed_content("b") == (3,)
    assert parser.get_parsed_content("d") == "monai_tpu_torch" and parser.get_parsed_content("f") == (0.0,)
    assert parser.get_parsed_content("g")() == (1,)
    assert ConfigExpression.is_import_statement("$import monai_tpu_torch")


ARGV = ["run", "--config_file", "configs/inference.json", "--bundle_root", "build/spleen_bundle",
        "--imports", json.dumps(overrides("monai_tpu_torch", "")["imports"]),
        "--initialize", json.dumps(overrides("monai_tpu_torch", "")["initialize"]),
        "--dataloader::num_workers", "2", "--roi_size", "[32, 32, 16]", "--overlap", "0.5", "--amp", "false",
        "positional", "--last"]


def test_command_line_parses_as_the_jax_one(monkeypatch):
    calls = []
    monkeypatch.setitem(jax_main.VERBS, "run", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setitem(port_main.VERBS, "run", lambda *a, **k: calls.append((a, k)))
    jax_main.main(ARGV)
    port_main.main(ARGV)
    assert len(calls) == 2 and calls[0] == calls[1]
    args, kwargs = calls[1]
    assert args == ("positional",) and kwargs["last"] is True and kwargs["dataloader::num_workers"] == 2
    assert kwargs["initialize"][1] == "$monai_tpu_torch.utils.set_determinism(seed=123)"
    assert kwargs["roi_size"] == [32, 32, 16] and kwargs["overlap"] == 0.5 and kwargs["amp"] is False


def test_run_needs_a_config_file():
    with pytest.raises(ValueError, match="config_file"):
        run(bundle_root=".")
