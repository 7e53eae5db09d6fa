"""Weight bridge: a monai_tpu UNet's parameters as a monai_tpu_torch ``state_dict``.

The input is keyed by the flattened nnx ``Param`` paths of ``monai_tpu``'s UNet, e.g.
``model.down.convs.0.conv.kernel``, ``model.down.convs.0.adn.2.alpha`` or
``model.up.mods.0.conv.kernel``; the output by torch MONAI's names, which the port's
UNet uses (``model.0.conv.unit0.conv.weight``, ``model.0.conv.unit0.adn.A.weight``,
``model.2.0.conv.weight``). Layouts: a conv kernel goes from (*K, I, O) to (O, I, *K);
a transposed-conv kernel from (*K, I, O) to (I, O, *K), spatially flipped, which
inverts ``monai_tpu/networks/torch_compat.py::convtrans_kernel_from_torch``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

__all__ = ["unet_state_dict_from_jax"]

_ADN_LEAVES = {"alpha": "A.weight", "scale": "N.weight", "bias": "N.bias"}


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


def unet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{nnx param path: array}`` of a monai_tpu UNet to the port's ``state_dict``
    (CPU float tensors, loadable with ``UNet.load_state_dict``)."""
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        toks = path.split(".")
        arr = np.asarray(value)
        if toks[-1] == "kernel":
            nsp = arr.ndim - 2
            if toks[-2] == "conv" and _is_transposed(toks):
                arr = np.flip(arr, axis=tuple(range(nsp))).transpose(nsp, nsp + 1, *range(nsp))
            else:
                arr = arr.transpose(nsp + 1, nsp, *range(nsp))
        out[_torch_key(toks)] = torch.tensor(np.ascontiguousarray(arr))
    return out
