"""``torch.export`` of the port's instance-norm UNet and SwinUNETR on the CPU: the kernels'
operators in the graph, the program against the module and the JAX net.

- Kernel 1, the instance norm (B2) and window attention (kernel 2) are each a
  ``torch.library`` operator (``torch.ops.monai_tpu_torch.conv3d_3x3_same``,
  ``instance_norm_prelu``, ``fused_window_attention``) with a fake version, and the
  wrappers send a traced (fake or functional) tensor to them. A program of an
  instance-norm UNet (32^3) and of a SwinUNETR of feature size 12 (64^3) calls all of
  its kernels' operators, equals its module within 1e-6 of max|ref|, and equals the JAX
  net's forward on the same weights (carried by ``networks.weights``) within the
  tolerance of the parity tests (1e-4 of max|ref| for the UNet, 1e-4 absolute and
  relative for SwinUNETR; the JAX window attention through its plain formulation).
- The program's constants are single values: SwinUNETR's shifted-window masks are built
  in its graph, not carried as constants.
- A fake-tensor call of each wrapper gives the eager output's shape, type and strides.
- The program saved and replayed by ``bundle.load_exported_network``, and the SwinUNETR's
  by ``torch.export.load`` in a fresh process that imports only ``monai_tpu_torch``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp
from flax import nnx

from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu.networks.nets import swin_unetr as jax_swin
from monai_tpu_torch.bundle import load_exported_network
from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu
from monai_tpu_torch.networks.nets import SwinUNETR, UNet
from monai_tpu_torch.networks.weights import swin_state_dict_from_jax, unet_state_dict_from_jax
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same
from monai_tpu_torch.ops.window_attention import fused_window_attention
from test_torch_swin_unetr import _abstract, _fill

REPO = Path(__file__).resolve().parents[1]
OPERATORS = {"unet": {"conv3d_3x3_same", "instance_norm_prelu"},
             "swinunetr": {"conv3d_3x3_same", "instance_norm_prelu", "fused_window_attention"}}


def _jax_unet(args, seed=3):
    net = nnx.eval_shape(lambda: JaxUNet(*args, num_res_units=2, rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(seed)
    variables = {}
    for path, var in nnx.state(net).flat_state():
        kind, shape = type(var).__name__, var.get_value().shape
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
        elif kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
        else:
            lo, hi = (0.5, 1.5) if path[-1] == "scale" else (-0.5, 0.5)
            variables[".".join(map(str, path))] = value = rng.uniform(lo, hi, shape).astype(np.float32)
            var.set_value(jnp.asarray(value))
    return net, variables


def _nets(name):
    """(the JAX net, the port's with its weights, an input)."""
    if name == "unet":
        args = (3, 1, 2, (8, 16, 32), (2, 2))
        jax_net, variables = _jax_unet(args)
        port = UNet(*args, num_res_units=2, device="cpu")
        port.load_state_dict(unet_state_dict_from_jax(variables))
        shape = (1, 1, 32, 32, 32)
    else:
        jax_net = _abstract(lambda r: jax_swin.SwinUNETR(1, 2, feature_size=12, rngs=r))
        port = SwinUNETR(1, 2, feature_size=12, device="cpu")
        port.load_state_dict(swin_state_dict_from_jax(_fill(jax_net, 21)))
        shape = (1, 1, 64, 64, 64)
    return jax_net, port.eval(), np.random.RandomState(22).rand(*shape).astype(np.float32)


@pytest.fixture(scope="module", params=["unet", "swinunetr"])
def exported(request, tmp_path_factory):
    jax_net, port, x = _nets(request.param)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        program = torch.export.export(port, (xt,), strict=False)
        eager = port(xt)
    graphdef, state = nnx.split(jax_net)
    ref = np.asarray(jax.jit(lambda s, a: nnx.merge(graphdef, s)(a))(state, jnp.asarray(x)))
    path = tmp_path_factory.mktemp("export") / "model.pt2"
    torch.export.save(program, str(path))
    return request.param, program, xt, eager, ref, path


def test_program_calls_the_kernels_operators(exported):
    """The graph calls the operators; the shifted-window masks are built in it, not lifted
    as constants (BTCV's first mask is 161 MB, which a program would copy to the card at
    every call): its constants are single values."""
    name, program, *_ = exported
    called = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    ours = {t.split(".")[1] for t in called if t.startswith("monai_tpu_torch.")}
    assert ours == OPERATORS[name], called
    assert all(v.numel() <= 1 for v in program.constants.values())


def test_program_matches_module_and_jax(exported):
    name, program, xt, eager, ref, _ = exported
    with torch.no_grad():
        got = program.module()(xt)
    assert got.shape == eager.shape == ref.shape and got.dtype == torch.float32
    assert (got - eager).abs().max().item() <= 1e-6 * eager.abs().max().item()
    if name == "unet":
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_saved_program_replays(exported):
    """Through ``load_exported_network``, and (the SwinUNETR's, which calls all three
    operators) through ``torch.export.load`` in a process that imports nothing of the port
    but the package."""
    name, _, xt, eager, _, path = exported
    got = load_exported_network(str(path))(xt)
    assert (got - eager).abs().max().item() <= 1e-6 * eager.abs().max().item()
    if name != "swinunetr":
        return
    torch.save(xt, path.with_suffix(".x"))
    code = ("import sys, torch, monai_tpu_torch\n"
            f"x = torch.load({str(path.with_suffix('.x'))!r})\n"
            f"y = torch.export.load({str(path)!r}).module()(x)\n"
            f"torch.save(y, {str(path.with_suffix('.y'))!r})\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
    assert torch.equal(torch.load(path.with_suffix(".y")), got)


def _fake_matches(fn, *tensors):
    """The wrapper on fake copies of ``tensors`` (a traced call, which goes through the
    operator) against the eager call: shape, type and strides."""
    eager = fn(*tensors)
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fakes = [None if t is None else mode.from_tensor(t) for t in tensors]
        fake = fn(*fakes)
    assert type(fake) is not torch.Tensor
    assert (fake.shape, fake.dtype, fake.stride()) == (eager.shape, eager.dtype, eager.stride())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine,slope", [(False, None), (True, (1,)), (True, (6,))])
def test_norm_operator_fake_matches_eager(dtype, affine, slope):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 6, 5, 4, 3), generator=g).to(dtype).contiguous(memory_format=torch.channels_last_3d)
    w = torch.rand(6, generator=g).to(dtype) if affine else None
    b = torch.rand(6, generator=g).to(dtype) if affine else None
    a = None if slope is None else torch.rand(slope, generator=g).to(dtype)
    _fake_matches(lambda x_, w_, b_, a_: instance_norm_prelu(x_, w_, b_, a_, 1e-5), x, w, b, a)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_operator_fake_matches_eager(masked):
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((4, 3, 8, 4), generator=g) for _ in range(3))
    bias = torch.randn((3, 8, 8), generator=g)
    mask = torch.randn((2, 8, 8), generator=g) if masked else None
    _fake_matches(fused_window_attention, q, k, v, bias, mask)


def test_conv_operator_fake_matches_eager():
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn((1, 4, 5, 6, 3), generator=g), torch.randn((3, 3, 3, 3, 2), generator=g)
    _fake_matches(conv3d_3x3_same, x, w)
