"""Weight bridge: a monai_tpu UNet's, SwinUNETR's, SegResNet's (and SegResNetVAE's), DenseNet's,
DynUNet's, ViT's (and ViTAutoEnc's), UNETR's or trainable bilateral filter's parameters as a
monai_tpu_torch ``state_dict``.

The input is keyed by the flattened nnx variable paths of ``monai_tpu``'s network, e.g.
``model.down.convs.0.conv.kernel``, ``model.down.convs.0.adn.2.alpha`` or
``model.up.mods.0.conv.kernel`` (and ``model.down.convs.0.adn.0.mean`` for a batch
norm's statistics); the output by torch MONAI's names, which the port's
networks use (``model.0.conv.unit0.conv.weight``, ``model.0.conv.unit0.adn.A.weight``,
``model.2.0.conv.weight``). Layouts: a conv kernel goes from (*K, I, O) to (O, I, *K);
a transposed-conv kernel from (*K, I, O) to (I, O, *K), spatially flipped, which
inverts ``monai_tpu/networks/torch_compat.py::convtrans_kernel_from_torch``; a linear
kernel (I, O) is transposed to (O, I); a norm's ``scale`` is its ``weight``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

__all__ = ["densenet_state_dict_from_jax", "dynunet_state_dict_from_jax", "filter_state_dict_from_jax",
           "segresnet_state_dict_from_jax", "swin_state_dict_from_jax", "unet_state_dict_from_jax",
           "unetr_state_dict_from_jax", "vit_state_dict_from_jax"]

_ADN_LEAVES = {"alpha": "A.weight", "scale": "N.weight", "bias": "N.bias", "mean": "N.running_mean",
               "var": "N.running_var"}


def _torch_key(toks: list[str]) -> str:
    out: list[str] = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if t == "down":
            out.append("0")
        elif t == "skip":
            out.append("1")
        elif t == "up":
            out.append("2")
        elif t == "mods":  # the up layer's Sequential(Convolution, ResidualUnit)
            out.append(toks[i + 1])
            i += 1
        elif t == "convs":  # a ResidualUnit's subunits
            out += ["conv", f"unit{toks[i + 1]}"]
            i += 1
        elif t == "adn":  # adn.<index in the ordering>.<leaf>
            if len(toks) != i + 3 or toks[i + 2] not in _ADN_LEAVES:
                raise KeyError(f"unexpected ADN parameter path {'.'.join(toks)}")
            out += ["adn", _ADN_LEAVES[toks[i + 2]]]
            break
        elif t == "kernel":
            out.append("weight")
        elif t in ("model", "submodule", "conv", "residual", "bias"):
            out.append(t)
        else:
            raise KeyError(f"cannot map token '{t}' of {'.'.join(toks)}")
        i += 1
    return ".".join(out)


def _is_transposed(toks: list[str]) -> bool:
    """The up layer's own conv (``up.conv`` or ``up.mods.0.conv``) is the transposed one."""
    head = toks[:-2]  # drop "conv", "kernel"
    return head[-1:] == ["up"] or head[-3:] == ["up", "mods", "0"]


def _conv_weight(arr: np.ndarray, transposed: bool) -> np.ndarray:
    nsp = arr.ndim - 2
    if transposed:
        return np.flip(arr, axis=tuple(range(nsp))).transpose(nsp, nsp + 1, *range(nsp)).copy()  # positive strides
    return arr.transpose(nsp + 1, nsp, *range(nsp))


def unet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu UNet (its ``Param``s and, with a
    batch norm, its ``BatchStat``s) to the port's ``state_dict`` (CPU tensors, loadable
    with ``UNet.load_state_dict(strict=True)``). A batch norm's ``mean`` and ``var``
    become ``running_mean`` and ``running_var``, and it gains ``num_batches_tracked``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        toks = path.split(".")
        arr = np.asarray(value)
        if toks[-1] == "kernel":
            arr = _conv_weight(arr, toks[-2] == "conv" and _is_transposed(toks))
        key = _torch_key(toks)
        out[key] = torch.tensor(np.ascontiguousarray(arr))
        if key.endswith(".N.running_mean"):
            out[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


# modules of the DynUNet blocks (and UnetOutBlock's ``conv``) that are a torch MONAI
# ``Convolution``, whose conv is one level down
_CONV_WRAPPED = {"conv1", "conv2", "conv3", "transp_conv", "conv"}


def swin_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu SwinUNETR (its ``Param``s and the
    ``relative_position_index`` variables) to the port's ``state_dict``, loadable with
    ``SwinUNETR.load_state_dict``: ``swinViT.layers.<i>`` becomes ``swinViT.layers<i+1>.0``,
    a DynUNet block's conv and the output conv gain the ``.conv`` level of torch MONAI's
    ``Convolution``, and ``kernel`` / ``scale`` become ``weight``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        toks = path.split(".")
        arr = np.asarray(value)
        key: list[str] = []
        i = 0
        while i < len(toks) - 1:
            t = toks[i]
            if t == "layers" and key == ["swinViT"]:
                key += [f"layers{int(toks[i + 1]) + 1}", "0"]
                i += 1
            else:
                key.append(t)
            i += 1
        name, arr = _block_param(key, toks[-1], arr, path)
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def _block_param(key: list[str], leaf: str, arr: np.ndarray, path: str) -> tuple[str, np.ndarray]:
    """The port's name and array of a DynUNet-family parameter: ``key`` the module path,
    ``leaf`` the nnx leaf. A conv of ``_CONV_WRAPPED`` gains the ``.conv`` level of torch
    MONAI's ``Convolution``; ``kernel`` and ``scale`` become ``weight``."""
    parent = key[-1]
    if parent in _CONV_WRAPPED:
        key = key + ["conv"]
    if leaf == "kernel":
        if arr.ndim == 2:  # nnx.Linear (I, O)
            arr = arr.T
        else:
            arr = _conv_weight(arr, parent == "transp_conv")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf not in ("bias", "relative_position_bias_table", "relative_position_index"):
        raise KeyError(f"cannot map {path}")
    if leaf == "relative_position_index":
        arr = arr.astype(np.int64)
    return ".".join(key + [leaf]), arr


def dynunet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu DynUNet (its ``Param``s) to the
    port's ``state_dict``, loadable with ``DynUNet.load_state_dict(strict=True)``: the
    module paths are the same (``upsamples.0.conv_block.conv1``), each conv gains the
    ``.conv`` level of torch MONAI's ``Convolution``, a transposed conv's kernel is flipped,
    and ``kernel`` / ``scale`` become ``weight``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        toks = path.split(".")
        name, arr = _block_param(toks[:-1], toks[-1], np.asarray(value), path)
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def segresnet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu SegResNet or SegResNetVAE (its
    ``Param``s) to the port's ``state_dict``, loadable with ``load_state_dict(strict=True)``.
    A level of ``down_layers`` is the JAX list ``[blocks]`` at the first level and
    ``[pre_conv, blocks]`` after it, the port's one ``Sequential(pre_conv or Identity,
    *blocks)``; every conv gains the ``.conv`` level of ``Convolution`` (DHWIO kernels to
    OIDHW) but an ``UpSample``'s own (``deconv``, transposed, and ``pixelshuffle.conv_block``),
    the VAE's linear layers' kernels (I, O) are transposed, and a group norm's ``scale`` is
    its ``weight``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        toks = path.split(".")
        arr = np.asarray(value)
        if toks[0] == "down_layers":  # down_layers.<level>.<0 or 1>[.<block>].<rest>
            level, part, rest = int(toks[1]), int(toks[2]), toks[3:]
            if level > 0 and part == 0:  # the stride-2 pre_conv
                toks = ["down_layers", str(level), "0", *rest]
            else:
                toks = ["down_layers", str(level), str(int(rest[0]) + 1), *rest[1:]]
        leaf = toks[-1]
        if toks[0] in ("vae_fc1", "vae_fc2", "vae_fc3") or toks[-2] in ("deconv", "conv_block"):
            if leaf == "kernel":
                toks[-1] = "weight"
                arr = arr.T if arr.ndim == 2 else _conv_weight(arr, toks[-2] == "deconv")
        elif leaf == "kernel":
            toks = [*toks[:-1], "conv", "weight"]
            arr = _conv_weight(arr, False)
        elif toks[-2] in ("conv_final", "vae_conv_final") and leaf == "bias":  # the convs with a bias
            toks = [*toks[:-1], "conv", "bias"]
        elif leaf == "scale":
            toks = [*toks[:-1], "weight"]
        elif leaf != "bias":
            raise KeyError(f"cannot map {path}")
        out[".".join(toks)] = torch.tensor(np.ascontiguousarray(arr))
    return out


_NORM_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def densenet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu DenseNet (its ``Param``s and its
    batch norms' ``BatchStat``s) to the port's ``state_dict``, loadable with
    ``DenseNet.load_state_dict(strict=True)``. The JAX net's ``blocks`` list alternates dense
    blocks and transitions and ends with the last norm: ``blocks.<2i>.layers.<j>`` is
    ``features.denseblock<i+1>.denselayer<j+1>.layers``, ``blocks.<2i+1>``
    ``features.transition<i+1>``, the last ``features.norm5``; ``conv0``, ``norm0`` and
    ``classifier`` are ``features.conv0``, ``features.norm0`` and ``class_layers.out``.
    Conv kernels (*K, I, O) become (O, I, *K), the linear kernel (I, O) is transposed, a
    norm's ``scale``, ``mean`` and ``var`` are its ``weight``, ``running_mean`` and
    ``running_var``, and each norm gains ``num_batches_tracked``."""
    last = max(int(p.split(".")[1]) for p in params if p.startswith("blocks."))
    out: dict[str, torch.Tensor] = {}
    norms = set()
    for path, value in params.items():
        toks = path.split(".")
        arr = np.asarray(value)
        if toks[0] == "blocks":
            b = int(toks[1])
            if b == last:
                head = ["features", "norm5"]
            elif b % 2 == 0:
                head = ["features", f"denseblock{b // 2 + 1}", f"denselayer{int(toks[3]) + 1}", "layers"]
                toks = toks[2:]
            else:
                head = ["features", f"transition{b // 2 + 1}"]
            toks = head + toks[2:]
        elif toks[0] in ("conv0", "norm0"):
            toks = ["features", *toks]
        elif toks[0] == "classifier":
            toks = ["class_layers", "out", *toks[1:]]
        else:
            raise KeyError(f"cannot map {path}")
        leaf = toks[-1]
        if leaf == "kernel":
            arr = arr.T if toks[1] == "out" else _conv_weight(arr, False)
            toks[-1] = "weight"
        elif toks[1] != "out":
            if leaf not in _NORM_LEAVES:
                raise KeyError(f"cannot map {path}")
            toks[-1] = _NORM_LEAVES[leaf]
            norms.add(".".join(toks[:-1]))
        out[".".join(toks)] = torch.tensor(np.ascontiguousarray(arr))
    for norm in norms:
        out[f"{norm}.num_batches_tracked"] = torch.tensor(0)
    return out


def filter_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu ``TrainableBilateralFilter`` or
    ``TrainableJointBilateralFilter`` (``sigma_spatial``, ``sigma_color``) to the port's
    ``state_dict``: a float32 vector of 1 or one per spatial axis and a float32 scalar."""
    shapes = {"sigma_spatial": (-1,), "sigma_color": ()}
    if set(params) != set(shapes):
        raise KeyError(f"a trainable filter has the parameters {sorted(shapes)}; got {sorted(params)}")
    return {k: torch.tensor(np.asarray(v, dtype=np.float32).reshape(shapes[k])) for k, v in params.items()}


def _vit_param(toks: list[str], arr: np.ndarray, path: str, perceptron: bool) -> tuple[str, np.ndarray]:
    """The port's name and array of a ViT or ViTAutoEnc parameter, ``toks`` its nnx path
    under the ViT: a linear kernel (I, O) is transposed, the ``perceptron``'s linear is
    ``patch_embeddings.1`` (after torch MONAI's ``Rearrange``), the classification head's is
    ``classification_head.0``, the decoder's ``conv3d_transpose*``
    kernels are transposed convs, and ``scale`` is ``weight``."""
    leaf, parent = toks[-1], toks[-2] if len(toks) > 1 else ""
    key = toks[:-1]
    if parent == "patch_embeddings" and perceptron or parent == "classification_head":
        key = key + ["1" if parent == "patch_embeddings" else "0"]
    if leaf == "kernel":
        arr = arr.T if arr.ndim == 2 else _conv_weight(arr, parent.startswith("conv3d_transpose"))
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf not in ("bias", "position_embeddings", "cls_token"):
        raise KeyError(f"cannot map {path}")
    return ".".join(key + [leaf]), arr


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu ViT or ViTAutoEnc (its ``Param``s) to
    the port's ``state_dict``, loadable with ``load_state_dict(strict=True)``: the module
    paths are the same (``blocks.0.attn.qkv``, ``blocks.0.mlp.linear1``,
    ``patch_embedding.position_embeddings``), linear kernels (I, O) become (O, I), conv kernels
    (*K, I, O) become (O, I, *K) (the decoder's transposed ones (I, O, *K), flipped), the
    ``"perceptron"`` patch embedding's linear is ``patch_embedding.patch_embeddings.1``, and
    with ``classification`` the head's linear is ``classification_head.0``."""
    perceptron = any(p.endswith("patch_embeddings.kernel") and np.ndim(v) == 2 for p, v in params.items())
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        name, arr = _vit_param(path.split("."), np.asarray(value), path, perceptron)
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def unetr_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx variable path: array}`` of a monai_tpu UNETR (its ``Param``s) to the port's
    ``state_dict``, loadable with ``UNETR.load_state_dict(strict=True)``: ``vit.*`` as
    ``vit_state_dict_from_jax``; each conv of the conv blocks gains the ``.conv`` level of
    torch MONAI's ``Convolution`` (``encoder1.layer.conv1.conv.weight``,
    ``decoder5.transp_conv.conv.weight``, ``out.conv.conv.weight``); a ``UnetrPrUpBlock``'s
    ``transp_conv_init`` and ``blocks.<i>.0`` are transposed convs, and without a conv block
    the JAX ``blocks.<i>.0`` is the port's ``blocks.<i>``."""
    vit = {p[len("vit."):]: v for p, v in params.items() if p.startswith("vit.")}
    out = {f"vit.{k}": v for k, v in vit_state_dict_from_jax(vit).items()}
    conv_blocks = {p.split(".")[0] for p in params if ".blocks." in p and p.split(".")[3:4] == ["1"]}
    for path, value in params.items():
        if path.startswith("vit."):
            continue
        toks = path.split(".")
        key, leaf, arr = toks[:-1], toks[-1], np.asarray(value)
        init = len(key) > 1 and key[1] == "transp_conv_init"
        if init or len(key) > 3 and key[1] == "blocks" and key[3] == "0":  # a transposed conv
            if not init and key[0] not in conv_blocks:
                key = key[:3]
            if leaf == "kernel":
                leaf, arr = "weight", _conv_weight(arr, True)
            name = ".".join(key + ["conv", leaf])
        else:
            name, arr = _block_param(key, leaf, arr, path)
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out
