"""ADN: optional Activation / Dropout / Normalization in a given order (counterpart of
monai_tpu/networks/blocks/acti_norm.py), with torch MONAI's child names N, D and A."""
from __future__ import annotations

from torch import nn

from ..layers.factories import get_act_layer, get_dropout_layer, get_norm_layer
from ..layers.fast_norm import InstanceNorm

__all__ = ["ADN"]


class ADN(nn.Sequential):
    """``ordering`` e.g. "NDA" applies norm, dropout, then activation."""

    def __init__(self, ordering: str = "NDA", in_channels: int | None = None, act="PRELU", norm=None,
                 norm_dim: int | None = None, dropout=None, dropout_dim: int | None = None,
                 device=None, dtype=None):
        super().__init__()
        if any(item not in "ADN" for item in ordering.upper()):
            raise ValueError(f"ordering must only contain A, D, N; got {ordering}")
        if norm is not None and norm_dim is None and dropout_dim is None:
            raise ValueError("norm_dim or dropout_dim needs to be specified.")
        dims = norm_dim or dropout_dim or 1
        for item in ordering.upper():
            if item == "N" and norm is not None:
                if in_channels is None:
                    raise ValueError("in_channels is required for the norm layer.")
                self.add_module("N", get_norm_layer(norm, dims, in_channels, device=device, dtype=dtype))
            elif item == "D" and dropout is not None:
                self.add_module("D", get_dropout_layer(dropout, dropout_dim or dims))
            elif item == "A" and act is not None:
                self.add_module("A", get_act_layer(act, device=device, dtype=dtype))

    def is_norm_prelu(self) -> bool:
        """True when the block is instance norm, then at most a dropout with p = 0, then
        PReLU: the case that ``instance_norm_prelu`` computes in one kernel."""
        names = list(self._modules)
        if names not in (["N", "A"], ["N", "D", "A"]):
            return False
        return (isinstance(self.N, InstanceNorm) and isinstance(self.A, nn.PReLU)
                and (names == ["N", "A"] or self.D.p == 0.0))
