"""The nnU-Net plans bridge (counterpart of ``get_jax_network_from_nnunet_plans`` in
monai_tpu/apps/nnunet/nnunet_bundle.py): an nnU-Net v2 plans file and dataset file to the
port's ``DynUNet``, without the ``nnunetv2`` package. torch MONAI's
``get_network_from_nnunet_plans`` returns the same network as a torch module through
``nnunetv2``; the other nnU-Net functions are not ported (ROADMAP A7)."""
from __future__ import annotations

import json
from pathlib import Path

import torch

from ...networks.nets.dynunet import DynUNet

__all__ = ["get_network_from_nnunet_plans"]


def _load_json(source: str | Path | dict) -> dict:
    if isinstance(source, dict):
        return source
    with open(source) as f:
        return json.load(f)


def get_network_from_nnunet_plans(plans_file: str | Path | dict, dataset_file: str | Path | dict,
                                  configuration: str = "3d_fullres", deep_supervision: bool = False,
                                  device=None, generator: torch.Generator | None = None) -> DynUNet:
    """The ``DynUNet`` of ``configuration`` in an nnU-Net v2 plans dict or file (the schema
    nnunetv2 2.2 and later write: ``configurations.<name>.architecture`` with
    ``network_class_name`` and ``arch_kwargs``) and a dataset dict or file.

    ``PlainConvUNet`` maps onto basic blocks, ``ResidualEncoderUNet`` onto residual blocks;
    both take 2 convs a stage, and any other count or class raises rather than build
    another network. The norm is instance norm with the plans' ``affine`` (eps 1e-5 and no
    conv bias, as the JAX package builds it), the activation a LeakyReLU of the plans'
    slope (0.01 by default); the input channels are the dataset's ``channel_names``, the
    output channels its labels but the background, plus one. With ``deep_supervision``
    the net has ``min(n_stages - 2, 3)`` heads (at least 1). ``device=None`` is the CUDA
    card."""
    plans = _load_json(plans_file)
    dataset_json = _load_json(dataset_file)
    try:
        cfg = plans["configurations"][configuration]
    except KeyError as e:
        raise KeyError(f"configuration {configuration!r} not in plans "
                       f"(has {sorted(plans.get('configurations', {}))})") from e
    arch = cfg["architecture"]
    class_name = arch["network_class_name"].rsplit(".", 1)[-1]
    if class_name not in ("PlainConvUNet", "ResidualEncoderUNet"):
        raise NotImplementedError(f"nnU-Net architecture {arch['network_class_name']!r} has no DynUNet mapping; "
                                  "supported: PlainConvUNet, ResidualEncoderUNet.")
    kw = arch["arch_kwargs"]
    spatial_dims = 3 if str(kw.get("conv_op", "Conv3d")).endswith("3d") else 2
    n_stages = int(kw["n_stages"])
    per_stage = kw.get("n_conv_per_stage", 2)
    per_stage = list(per_stage) if isinstance(per_stage, (list, tuple)) else [per_stage] * n_stages
    if any(int(c) != 2 for c in per_stage):
        raise NotImplementedError(f"n_conv_per_stage={per_stage}: DynUNet stages are 2-conv blocks; refusing "
                                  "to build a structurally different network.")

    def per_axis(v) -> list:
        return list(v) if isinstance(v, (list, tuple)) else [v] * spatial_dims

    kernel_sizes = [per_axis(k) for k in kw["kernel_sizes"]]
    strides = [per_axis(s) for s in kw["strides"]]
    norm_name = ("instance", {"affine": bool((kw.get("norm_op_kwargs") or {}).get("affine", True))})
    nonlin = str(kw.get("nonlin", "LeakyReLU")).rsplit(".", 1)[-1].lower()
    if nonlin == "leakyrelu":
        slope = float((kw.get("nonlin_kwargs") or {}).get("negative_slope", 0.01))
        act_name = ("leakyrelu", {"negative_slope": slope})
    else:
        act_name = (nonlin, {})
    in_channels = len(dataset_json.get("channel_names") or dataset_json.get("modality") or {"0": "x"})
    labels = dataset_json.get("labels", {})
    # a v2 dataset.json maps a name to an index, a region to a list of them
    n_fg = len({int(i) for v in labels.values() for i in (v if isinstance(v, (list, tuple)) else [v])} - {0}) \
        if labels else 1
    return DynUNet(spatial_dims, in_channels, n_fg + 1, kernel_sizes, strides, strides[1:],
                   filters=list(kw["features_per_stage"]), norm_name=norm_name, act_name=act_name,
                   deep_supervision=deep_supervision,
                   deep_supr_num=max(1, min(n_stages - 2, 3)) if deep_supervision else 1,
                   res_block=class_name == "ResidualEncoderUNet", device=device, generator=generator)
