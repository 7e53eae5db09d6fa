"""The port's bundle verbs against the JAX package's, on the CPU.

- ``VERBS`` of ``python -m monai_tpu_torch.bundle`` has the JAX command line's keys.
- ``ConfigParser.export_config_file`` writes JSON and YAML that both packages read back
  as the config they wrote, and both refuse another format.
- ``PythonicWorkflow``: a property set on the workflow, computed by its ``get_<name>``
  (once), or read from its config; a required one that none gives raises, in both.
- ``verify_metadata`` gives each ``bundles/*/configs/metadata.json`` the JAX verdict (each
  lacks ``monai_version`` and ``numpy_version``, which the structural check requires), and
  passes a metadata that has them, by that check and by a local JSON schema.
- ``verify_net_in_out`` runs the Spleen ``inference.json``'s network (narrowed to 4-8
  channels by overrides) on the CPU and checks its output channels; a metadata that names
  3 output channels is refused with the JAX package's message.
- ``ckpt_export`` of a small instance-norm UNet with the weights of a JAX one (a torch file
  of ``unet_state_dict_from_jax``): the port's ``torch.export`` program, replayed by
  ``load_exported_network``, within 1e-5 of max|ref| of the JAX net's jitted forward on
  one input (the JAX package's ``ckpt_export`` exports that forward; its eager build of the
  net from the config costs ~10 s here, so it is not run); its graph calls kernel 1
  as ``torch.ops.monai_tpu_torch.conv3d_3x3_same``. A batch-norm UNet's program equals its
  eval-mode forward bit for bit. ``config.json`` reads back as the config.
- ``init_bundle``, ``download`` offline and ``load`` of a local bundle; ``run_workflow`` and
  ``create_workflow`` run a config's items as the JAX package's do.
- Kernel 1's operator gives the wrapper's output, its fake version the output's shape, and it
  has no backward.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

import monai_tpu.bundle.__main__ as jax_main
import monai_tpu.bundle.scripts as jax_scripts
from monai_tpu.bundle import ConfigParser as JaxConfigParser
from monai_tpu.bundle import PythonicWorkflow as JaxPythonicWorkflow
from monai_tpu.networks.nets import UNet as JaxUNet
import monai_tpu_torch.bundle.__main__ as port_main
from monai_tpu_torch.bundle import ConfigParser, PythonicWorkflow, scripts
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
SPLEEN = REPO / "bundles" / "spleen_ct_segmentation" / "configs"
METADATA = sorted((REPO / "bundles").glob("*/configs/metadata.json"))
SMALL_NET = {"_target_": "UNet", "spatial_dims": 3, "in_channels": 1, "out_channels": 2, "channels": [4, 8],
             "strides": [2], "num_res_units": 1}


def test_verbs_are_the_jax_verbs():
    assert sorted(port_main.VERBS) == sorted(jax_main.VERBS)
    assert all(callable(v) for v in port_main.VERBS.values())


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_export_config_file_round_trip(fmt, tmp_path):
    config = json.loads((SPLEEN / "inference.json").read_text())
    for name, cls in (("jax", JaxConfigParser), ("port", ConfigParser)):
        path = tmp_path / f"{name}.{fmt}"
        cls.export_config_file(config, str(path), fmt=fmt)
        assert cls.load_config_file(str(path)) == config
        assert ConfigParser.load_config_file(str(path)) == JaxConfigParser.load_config_file(str(path))
        with pytest.raises(ValueError, match="only support JSON or YAML"):
            cls.export_config_file(config, str(tmp_path / f"{name}.txt"), fmt="toml")


def _pythonic(base):
    class Flow(base):
        calls = 0

        def get_network_def(self):
            type(self).calls += 1
            return "net"

    return Flow


def test_pythonic_workflow_properties(tmp_path):
    config = tmp_path / "c.json"
    config.write_text(json.dumps({"device": "$'cpu'", "inferer": {"roi": 3}}))
    seen = []
    for base in (JaxPythonicWorkflow, PythonicWorkflow):
        flow = _pythonic(base)(workflow_type="infer", config_file=str(config), dataset_dir="/d")
        with pytest.raises(RuntimeError, match="initialize"):
            flow.device
        flow.initialize()
        with pytest.raises(KeyError, match="bundle_root"):
            flow.bundle_root
        flow.bundle_root = "/b"
        got = (flow.bundle_root, flow.device, flow.dataset_dir, flow.network_def, flow.network_def, flow.inferer,
               flow.preprocessing, type(flow).calls, flow.workflow_type)
        with pytest.raises(NotImplementedError):
            flow.run()
        seen.append(got)
    assert seen[0] == seen[1] == ("/b", "cpu", "/d", "net", "net", {"roi": 3}, None, 1, "infer")


@pytest.mark.parametrize("meta", METADATA, ids=[p.parts[-3] for p in METADATA])
def test_verify_metadata_verdict(meta):
    verdicts = []
    for verify in (jax_scripts.verify_metadata, scripts.verify_metadata):
        with pytest.raises(ValueError) as e:
            verify(meta_file=str(meta))
        verdicts.append(str(e.value))
    assert verdicts[0] == verdicts[1] == "metadata missing required keys: ['monai_version', 'numpy_version']"


def test_verify_metadata_passes_complete_metadata(tmp_path):
    meta = json.loads((SPLEEN / "metadata.json").read_text())
    meta.update(monai_version="0.1.0", numpy_version=np.__version__)
    path = tmp_path / "metadata.json"
    path.write_text(json.dumps(meta))
    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps({"type": "object", "required": ["version", "network_data_format"]}))
    bad = tmp_path / "bad_schema.json"
    bad.write_text(json.dumps({"type": "object", "required": ["not_there"]}))
    for verify in (jax_scripts.verify_metadata, scripts.verify_metadata):
        assert verify(meta_file=str(path)) is True
        assert verify(meta_file=str(path), filepath=str(schema)) is True
        with pytest.raises(Exception, match="not_there"):
            verify(meta_file=str(path), filepath=str(bad))


def test_verify_net_in_out(tmp_path):
    small = {"network::device": "cpu", "network::channels": [4, 8], "network::strides": [2]}
    net = scripts.verify_net_in_out(net_id="network", config_file=str(SPLEEN / "inference.json"),
                                    meta_file=str(SPLEEN / "metadata.json"), **small)
    assert isinstance(net, UNet) and tuple(net.channels) == (4, 8)
    meta = json.loads((SPLEEN / "metadata.json").read_text())
    meta["network_data_format"]["outputs"]["pred"]["channel_def"] = {"0": "a", "1": "b", "2": "c"}
    bad = tmp_path / "metadata.json"
    bad.write_text(json.dumps(meta))
    config = tmp_path / "small.json"
    config.write_text(json.dumps({"network": SMALL_NET}))
    with pytest.raises(ValueError, match="output channel number `2` doesn't match: `3`"):
        scripts.verify_net_in_out(net_id="network", config_file=str(config), meta_file=str(bad),
                                  **{"network::device": "cpu"})


def _jax_weights():
    """The JAX UNet built abstractly, its parameters drawn with numpy."""
    net = nnx.eval_shape(lambda: JaxUNet(3, 1, 2, (4, 8), (2,), num_res_units=1, rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(2)
    params = {}
    for path, var in nnx.state(net).flat_state():
        kind, shape = type(var).__name__, var.get_value().shape
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
        elif kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
        else:
            value = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
            var.set_value(jnp.asarray(value))
            params[".".join(map(str, path))] = value
    return net, params


def test_ckpt_export_matches_jax(tmp_path):
    config = tmp_path / "inference.json"
    config.write_text(json.dumps({"network": {**SMALL_NET, "norm": "instance"}}))
    net, params = _jax_weights()
    torch.save({"model": unet_state_dict_from_jax(params)}, tmp_path / "port.pt")
    shape = (1, 1, 16, 16, 16)
    out = scripts.ckpt_export(net_id="network", filepath=str(tmp_path / "port"), config_file=str(config),
                              ckpt_file=str(tmp_path / "port.pt"), input_shape=shape, **{"network::device": "cpu"})
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    y_ref = np.asarray(jax.jit(lambda m, v: m(v))(net, jnp.asarray(x)))
    y = scripts.load_exported_network(str(Path(out) / "model.pt2"))(torch.from_numpy(x))
    assert np.abs(y.numpy() - y_ref).max() <= 1e-5 * np.abs(y_ref).max()
    program = torch.export.load(str(Path(out) / "model.pt2"))
    assert "monai_tpu_torch.conv3d_3x3_same" in str(program.graph)
    assert sorted(p.name for p in Path(out).iterdir()) == ["config.json", "export_meta.json", "model.pt", "model.pt2"]
    assert json.loads((Path(out) / "config.json").read_text())["network"]["device"] == "cpu"
    assert torch.load(Path(out) / "model.pt", weights_only=True)["model"].keys() == unet_state_dict_from_jax(params).keys()


def test_ckpt_export_batch_norm_equals_eval_forward(tmp_path):
    config = tmp_path / "inference.json"
    config.write_text(json.dumps({"network": {**SMALL_NET, "norm": "batch", "device": "cpu"}}))
    torch.manual_seed(0)
    net = UNet(3, 1, 2, (4, 8), (2,), num_res_units=1, norm="batch", device="cpu")
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.3, 0.3)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0)
    torch.save({"model": net.state_dict()}, tmp_path / "best.pt")
    out = scripts.ckpt_export(net_id="network", filepath=str(tmp_path / "export"), config_file=str(config),
                              ckpt_file=str(tmp_path / "best.pt"), input_shape=(2, 1, 16, 16, 16))
    x = torch.rand(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net.eval()(x)
    assert torch.equal(scripts.load_exported_network(str(Path(out) / "model.pt2"))(x), want)


def test_init_download_and_load(tmp_path):
    for name, init in (("jax", jax_scripts.init_bundle), ("port", scripts.init_bundle)):
        root = Path(init(str(tmp_path / name / "mybundle")))
        assert sorted(p.name for p in root.iterdir()) == ["configs", "docs", "models"]
        assert sorted(p.name for p in (root / "configs").iterdir()) == ["inference.json", "metadata.json"]
    for download in (jax_scripts.download, scripts.download):
        with pytest.raises(RuntimeError, match="network downloads are unavailable"):
            download(name="spleen_ct_segmentation")
        assert download(url=str(tmp_path)) == str(tmp_path)
    root = tmp_path / "local" / "small"
    (root / "configs").mkdir(parents=True)
    (root / "models").mkdir()
    (root / "configs" / "inference.json").write_text(json.dumps({"network_def": {**SMALL_NET, "device": "cpu"}}))
    src = UNet(3, 1, 2, (4, 8), (2,), num_res_units=1, device="cpu")
    torch.save({"model": copy.deepcopy(src.state_dict())}, root / "models" / "model.pt")
    net = scripts.load("small", bundle_dir=str(tmp_path / "local"))
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(), src.state_dict().values()))
    with pytest.raises(FileNotFoundError):
        scripts.load("missing", bundle_dir=str(tmp_path))


def test_run_workflow_and_create_workflow(tmp_path):
    config = tmp_path / "flow.json"
    config.write_text(json.dumps({"bundle_root": "/b", "steps": [], "initialize": ["$@steps.append('init')"],
                                  "run": ["$@steps.append('run') or @scale * 2"],
                                  "finalize": ["$@steps.append('final')"], "scale": 3}))
    for m in (jax_scripts, scripts):
        flow = m.run_workflow(config_file=str(config), workflow_type="infer", scale=5)
        assert flow.parser.get_parsed_content("steps") == ["init", "run", "final"]
        assert flow.bundle_root == "/b" and flow.workflow_type == "infer"
        made = m.create_workflow(config_file=str(config), workflow_name="ConfigWorkflow")
        assert made.parser.get_parsed_content("steps") == ["init"]
    with pytest.raises(ValueError, match="cannot locate"):
        scripts.create_workflow(workflow_name="NoSuchWorkflow", config_file=str(config))


def test_kernel_operator_matches_the_wrapper():
    """``torch.ops.monai_tpu_torch.conv3d_3x3_same``, what an exported graph calls, against
    the eager wrapper: the same output (on the CPU, both the plain version); its fake
    version the output's shape and type; and no backward (export traces inference only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, 4, 3, generator=gen)
    w = torch.randn(3, 3, 3, 3, 4, generator=gen)
    b = torch.randn(4, generator=gen)
    with torch.no_grad():
        assert torch.equal(torch.ops.monai_tpu_torch.conv3d_3x3_same(x, w, b), conv3d_3x3_same(x, w, b))
    mode = FakeTensorMode()
    fx, fw = mode.from_tensor(x.bfloat16()), mode.from_tensor(w.bfloat16())
    with mode:
        fake = conv3d_3x3_same(fx, fw, None)
    assert tuple(fake.shape) == (2, 5, 6, 4, 4) and fake.dtype == torch.bfloat16
    with pytest.raises(RuntimeError):
        torch.ops.monai_tpu_torch.conv3d_3x3_same(x.requires_grad_(), w, b).sum().backward()
