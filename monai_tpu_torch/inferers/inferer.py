"""Inferer classes (counterpart of monai_tpu/inferers/inferer.py:18-64)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Sequence
from typing import Any

from ..utils.enums import BlendMode
from .utils import sliding_window_inference

__all__ = ["Inferer", "SimpleInferer", "SlidingWindowInferer"]


class Inferer(ABC):
    """Inference execution strategy."""

    @abstractmethod
    def __call__(self, inputs: Any, network: Callable, *args, **kwargs):
        raise NotImplementedError(f"Subclass {self.__class__.__name__} must implement this method.")


class SimpleInferer(Inferer):
    """``network(inputs)``."""

    def __call__(self, inputs: Any, network: Callable, *args, **kwargs):
        return network(inputs, *args, **kwargs)


class SlidingWindowInferer(Inferer):
    """Window-batched sliding-window inference (``sliding_window_inference``)."""

    def __init__(self, roi_size: Sequence[int] | int, sw_batch_size: int = 1,
                 overlap: Sequence[float] | float = 0.25, mode: str = BlendMode.CONSTANT,
                 sigma_scale: Sequence[float] | float = 0.125, padding_mode: str = "constant",
                 cval: float = 0.0):
        self.roi_size = roi_size
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.mode = mode
        self.sigma_scale = sigma_scale
        self.padding_mode = padding_mode
        self.cval = cval

    def __call__(self, inputs: Any, network: Callable, *args, **kwargs):
        # the named parameters go positionally, so extra *args reach the network
        return sliding_window_inference(inputs, self.roi_size, self.sw_batch_size, network, self.overlap,
                                        self.mode, self.sigma_scale, self.padding_mode, self.cval,
                                        *args, **kwargs)
