"""Enumerations (the subset of monai_tpu/utils/enums.py that the port uses)."""
from __future__ import annotations

from enum import Enum

__all__ = ["StrEnum", "BlendMode"]


class StrEnum(str, Enum):
    """Enum whose members are also strings (``str(Member) == value``)."""

    def __str__(self) -> str:
        return self.value

    def __repr__(self) -> str:
        return self.value


class BlendMode(StrEnum):
    """Sliding-window blending."""

    CONSTANT = "constant"
    GAUSSIAN = "gaussian"
