"""The nnU-Net plans bridge of monai_tpu_torch (``get_network_from_nnunet_plans``) against
monai_tpu's ``get_jax_network_from_nnunet_plans``, on the CPU, on a plans dict in the
schema nnunetv2 2.2 and later write (the fixture of tests/test_nnunet_plans_fixture.py).

- The same architecture: filters, kernel sizes, strides, upsample kernels, basic or
  residual blocks, the deep-supervision heads; for the 3d_fullres ``PlainConvUNet`` and the
  3d_lowres ``ResidualEncoderUNet``, from dicts and from files.
- The forward with the JAX net's weights carried across (``dynunet_state_dict_from_jax``):
  within 1e-5 of max|ref| of the port's float64 forward, and within 3e-5 of max|ref| of the
  JAX forward (whose float32 is itself off the float64 one, as in tests/test_torch_dynunet.py).
- The refusals: ``n_conv_per_stage`` other than 2, an architecture class that is not
  mapped, a configuration that is not in the plans.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from monai_tpu.apps.nnunet import get_jax_network_from_nnunet_plans
from monai_tpu_torch.apps.nnunet import get_network_from_nnunet_plans
from monai_tpu_torch.networks.weights import dynunet_state_dict_from_jax
from test_torch_dynunet import _float64

ARCH = {"n_conv_per_stage": [2, 2, 2, 2], "n_conv_per_stage_decoder": [2, 2, 2], "conv_bias": True,
        "conv_op": "torch.nn.modules.conv.Conv3d", "norm_op": "torch.nn.modules.instancenorm.InstanceNorm3d",
        "norm_op_kwargs": {"eps": 1e-05, "affine": True}, "dropout_op": None, "dropout_op_kwargs": None,
        "nonlin": "torch.nn.LeakyReLU", "nonlin_kwargs": {"inplace": True}}
NNUNET_PLANS = {
    "dataset_name": "Dataset009_Spleen",
    "plans_name": "nnUNetPlans",
    "original_median_spacing_after_transp": [2.5, 0.79, 0.79],
    "original_median_shape_after_transp": [90, 440, 440],
    "image_reader_writer": "SimpleITKIO",
    "transpose_forward": [0, 1, 2],
    "transpose_backward": [0, 1, 2],
    "experiment_planner_used": "ExperimentPlanner",
    "label_manager": "LabelManager",
    "configurations": {
        "3d_fullres": {
            "data_identifier": "nnUNetPlans_3d_fullres",
            "preprocessor_name": "DefaultPreprocessor",
            "batch_size": 2,
            "patch_size": [32, 64, 64],
            "spacing": [2.5, 0.79, 0.79],
            "normalization_schemes": ["CTNormalization"],
            "architecture": {
                "network_class_name": "dynamic_network_architectures.architectures.unet.PlainConvUNet",
                "arch_kwargs": {"n_stages": 4, "features_per_stage": [8, 16, 32, 64],
                                "kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]],
                                "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2]], **ARCH},
                "_kw_requires_import": ["conv_op", "norm_op", "dropout_op", "nonlin"],
            },
            "batch_dice": False,
        },
        "3d_lowres": {
            "inherits_from": "3d_fullres",
            "spacing": [5.0, 1.6, 1.6],
            "architecture": {
                "network_class_name": "dynamic_network_architectures.architectures.unet.ResidualEncoderUNet",
                "arch_kwargs": {"n_stages": 4, "features_per_stage": [8, 16, 32, 64], "kernel_sizes": [[3, 3, 3]] * 4,
                                "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2], [2, 2, 2]], **ARCH},
            },
        },
    },
}
DATASET_JSON = {"channel_names": {"0": "CT"}, "labels": {"background": 0, "spleen": 1}, "numTraining": 41,
                "file_ending": ".nii.gz", "name": "Dataset009_Spleen"}


def _fill(net, seed: int = 0) -> dict:
    """Every parameter of the JAX ``net`` drawn with numpy; returns {path: array}."""
    rng = np.random.RandomState(seed)
    params = {}
    for path, var in nnx.state(net).flat_state():
        shape, leaf = var.get_value().shape, path[-1]
        if leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias":
            a = rng.uniform(-0.2, 0.2, shape)
        else:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        var.set_value(jnp.asarray(a.astype(np.float32)))
        params[".".join(map(str, path))] = a.astype(np.float32)
    return params


@pytest.mark.parametrize("configuration,deep_supervision,shape", [
    ("3d_fullres", False, (16, 32, 32)), ("3d_fullres", True, (16, 32, 32)), ("3d_lowres", True, (16, 16, 16))])
def test_bridge_matches_jax(tmp_path, configuration, deep_supervision, shape):
    pf, df = tmp_path / "plans.json", tmp_path / "dataset.json"
    pf.write_text(json.dumps(NNUNET_PLANS))
    df.write_text(json.dumps(DATASET_JSON))
    ref_net = nnx.eval_shape(lambda: get_jax_network_from_nnunet_plans(
        str(pf), str(df), configuration, deep_supervision=deep_supervision, rngs=nnx.Rngs(0)))
    net = get_network_from_nnunet_plans(NNUNET_PLANS, DATASET_JSON, configuration, deep_supervision=deep_supervision,
                                        device="cpu")
    from_files = get_network_from_nnunet_plans(str(pf), str(df), configuration, deep_supervision=deep_supervision,
                                               device="cpu")
    for n in (net, from_files):
        assert n.filters == ref_net.filters
        assert [list(k) for k in n.kernel_size] == [list(k) for k in ref_net.kernel_size]
        assert [list(s) for s in n.strides] == [list(s) for s in ref_net.strides]
        assert [list(u) for u in n.upsample_kernel_size] == [list(u) for u in ref_net.upsample_kernel_size]
        assert n.deep_supervision == deep_supervision and n.deep_supr_num == ref_net.deep_supr_num
        assert type(n.input_block).__name__ == type(ref_net.input_block).__name__
        assert set(n.state_dict()) == set(net.state_dict())
    params = _fill(ref_net)
    net.load_state_dict(dynunet_state_dict_from_jax(params), strict=True)
    x = np.random.RandomState(1).rand(1, 1, *shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda m, a: m(a))(ref_net, jnp.asarray(x)))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        with _float64():
            exact = copy.deepcopy(net).double()(torch.from_numpy(x).double()).numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - exact).max() <= 1e-5 * scale
    assert np.abs(got - ref).max() <= 3e-5 * scale


def test_bridge_refuses_what_the_jax_one_refuses():
    plans = copy.deepcopy(NNUNET_PLANS)
    plans["configurations"]["3d_fullres"]["architecture"]["arch_kwargs"]["n_conv_per_stage"] = [2, 3, 2, 2]
    for build in (lambda p, c: get_jax_network_from_nnunet_plans(p, DATASET_JSON, c),
                  lambda p, c: get_network_from_nnunet_plans(p, DATASET_JSON, c, device="cpu")):
        with pytest.raises(NotImplementedError, match="n_conv_per_stage"):
            build(plans, "3d_fullres")
        with pytest.raises(KeyError, match="2d"):
            build(NNUNET_PLANS, "2d")
    plans = copy.deepcopy(NNUNET_PLANS)
    plans["configurations"]["3d_fullres"]["architecture"]["network_class_name"] = "my.nets.Transformer"
    with pytest.raises(NotImplementedError, match="Transformer"):
        get_jax_network_from_nnunet_plans(plans, DATASET_JSON, "3d_fullres")
    with pytest.raises(NotImplementedError, match="Transformer"):
        get_network_from_nnunet_plans(plans, DATASET_JSON, "3d_fullres", device="cpu")
