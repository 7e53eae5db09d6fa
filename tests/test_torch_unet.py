"""monai_tpu_torch's UNet against monai_tpu's, on the CPU, in float32.

A small UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2) in both packages: the JAX
net's parameters go through ``unet_state_dict_from_jax`` into the port, and the two
forwards agree to 1e-4 (absolute and relative; ~17 conv/norm layers of float32 sums in
another order). The port's ``state_dict`` keys are torch MONAI's, and loading them back
into a JAX net with ``torch_compat.load_torch_unet_state`` gives identical outputs.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu.networks.torch_compat import load_torch_unet_state
from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same

ARGS = (3, 1, 2, (4, 8, 16), (2, 2))

# torch MONAI's names for this UNet, in registration order
TORCH_MONAI_KEYS = [
    f"{p}.{k}"
    for p, ks in [
        ("model.0", ["conv.unit0.conv.weight", "conv.unit0.conv.bias", "conv.unit0.adn.A.weight",
                     "conv.unit1.conv.weight", "conv.unit1.conv.bias", "conv.unit1.adn.A.weight",
                     "residual.weight", "residual.bias"]),
        ("model.1.submodule.0", ["conv.unit0.conv.weight", "conv.unit0.conv.bias", "conv.unit0.adn.A.weight",
                                 "conv.unit1.conv.weight", "conv.unit1.conv.bias", "conv.unit1.adn.A.weight",
                                 "residual.weight", "residual.bias"]),
        ("model.1.submodule.1.submodule", ["conv.unit0.conv.weight", "conv.unit0.conv.bias",
                                           "conv.unit0.adn.A.weight", "conv.unit1.conv.weight",
                                           "conv.unit1.conv.bias", "conv.unit1.adn.A.weight",
                                           "residual.weight", "residual.bias"]),
        ("model.1.submodule.2", ["0.conv.weight", "0.conv.bias", "0.adn.A.weight",
                                 "1.conv.unit0.conv.weight", "1.conv.unit0.conv.bias", "1.conv.unit0.adn.A.weight"]),
        ("model.2", ["0.conv.weight", "0.conv.bias", "0.adn.A.weight",
                     "1.conv.unit0.conv.weight", "1.conv.unit0.conv.bias"]),
    ]
    for k in ks
]


def _jax_params(net) -> dict:
    return {".".join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.state(net, nnx.Param).flat_state()}


@pytest.fixture(scope="module")
def nets():
    jax_net = JaxUNet(*ARGS, num_res_units=2, rngs=nnx.Rngs(0))
    # nnx's zero bias and unit slope would hide a mis-mapped bias or slope: randomise them
    rng = np.random.RandomState(7)
    for path, var in nnx.state(jax_net, nnx.Param).flat_state():
        if path[-1] in ("bias", "alpha"):
            var.set_value(jnp.asarray(rng.uniform(0.05, 0.5, var.get_value().shape).astype(np.float32)))
    port = UNet(*ARGS, num_res_units=2, device="cpu").eval()
    port.load_state_dict(unet_state_dict_from_jax(_jax_params(jax_net)))
    return jax_net, port


def _x(seed=0, shape=(2, 1, 16, 16, 16)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_forward_matches_jax(nets):
    jax_net, port = nets
    x = _x()
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_net(jnp.asarray(x))), atol=1e-4, rtol=1e-4)


def test_state_dict_keys_are_torch_monai_names(nets):
    _, port = nets
    assert list(port.state_dict()) == TORCH_MONAI_KEYS


def test_bridge_maps_every_jax_param_with_its_shape(nets):
    jax_net, port = nets
    sd = unet_state_dict_from_jax(_jax_params(jax_net))
    assert sorted(sd) == sorted(TORCH_MONAI_KEYS)
    for k, v in port.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    # a transposed conv keeps (I, O, *K); a conv is (O, I, *K)
    assert tuple(sd["model.2.0.conv.weight"].shape) == (8, 2, 3, 3, 3)
    assert tuple(sd["model.2.1.conv.unit0.conv.weight"].shape) == (2, 2, 3, 3, 3)


def test_round_trip_through_torch_compat_gives_identical_outputs(nets):
    jax_net, port = nets
    jax_net2 = JaxUNet(*ARGS, num_res_units=2, rngs=nnx.Rngs(1))
    load_torch_unet_state(jax_net2, port.state_dict())
    x = jnp.asarray(_x(1))
    np.testing.assert_array_equal(np.asarray(jax_net2(x)), np.asarray(jax_net(x)))


def test_fused_sites_and_cpu_routing(nets):
    """Every conv+ADN of this net fuses norm and PReLU (9 sites), and on the CPU neither
    kernel is launched."""
    _, port = nets
    assert sum(getattr(m, "fused_norm_prelu", False) for m in port.modules()) == 9
    before = (conv3d_3x3_same.launches, instance_norm_prelu.launches)
    with torch.inference_mode():
        out = port(torch.from_numpy(_x(2)))
    assert out.shape == (2, 2, 16, 16, 16)
    assert (conv3d_3x3_same.launches, instance_norm_prelu.launches) == before


def test_plain_unet_without_res_units_matches_jax():
    """num_res_units=0: Convolution layers only, the top up layer conv-only."""
    jax_net = JaxUNet(*ARGS, num_res_units=0, rngs=nnx.Rngs(2))
    port = UNet(*ARGS, num_res_units=0, device="cpu").eval()
    port.load_state_dict(unet_state_dict_from_jax(_jax_params(jax_net)))
    x = _x(3, (1, 1, 8, 8, 8))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_net(jnp.asarray(x))), atol=1e-4, rtol=1e-4)


def test_float16_forward_matches_float32_and_jax(nets):
    """``.to(torch.float16)`` runs on the CPU: against the port's float32 forward and the
    JAX net given the same input as float16 (it computes in its float32 parameters and
    returns float32), to 2^-10 (float16's relative step) x 17 conv/norm layers of
    max|ref|."""
    jax_net, port = nets
    x = _x(4)
    x16 = x.astype(np.float16)
    with torch.inference_mode():
        ref32 = port(torch.from_numpy(x)).numpy()
        got = copy.deepcopy(port).to(torch.float16)(torch.from_numpy(x16))
    assert got.dtype == torch.float16 and got.shape == (2, 2, 16, 16, 16)
    tol = 2.0 ** -10 * 17
    for ref in (ref32, np.asarray(jax_net(jnp.asarray(x16)), dtype=np.float32)):
        assert np.abs(got.float().numpy() - ref).max() <= tol * np.abs(ref).max()
