"""Inferer classes (counterpart of monai_tpu/inferers/inferer.py:18-140)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Sequence
from typing import Any

import torch

from ..utils.enums import BlendMode
from .utils import sliding_window_inference

__all__ = ["Inferer", "SimpleInferer", "SlidingWindowInferer", "SlidingWindowInfererAdapt"]


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


class SlidingWindowInfererAdapt(SlidingWindowInferer):
    """Sliding-window inference that adapts to the card's memory: on
    ``torch.cuda.OutOfMemoryError`` it halves ``sw_batch_size`` and tries again; once at
    1, it stitches the output on the host, each window still running where the input
    lies. The adapted ``sw_batch_size`` stays on the instance, so later volumes skip the
    sizes that failed."""

    def __call__(self, inputs: Any, network: Callable, *args, **kwargs):
        while True:
            try:
                return super().__call__(inputs, network, *args, **kwargs)
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()  # a no-op where CUDA was never initialised
                if self.sw_batch_size > 1:
                    self.sw_batch_size = max(1, self.sw_batch_size // 2)
                    continue
                return sliding_window_inference(inputs, self.roi_size, 1, network, self.overlap, self.mode,
                                                self.sigma_scale, self.padding_mode, self.cval, *args,
                                                device="cpu", **kwargs)
