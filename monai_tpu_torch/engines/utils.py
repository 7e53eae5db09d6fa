"""Engine helpers (counterpart of monai_tpu/engines/utils.py: ``default_prepare_batch``)."""
from __future__ import annotations

import torch

from ..data.meta_image import MetaImage
from ..utils.enums import CommonKeys
from .events import IterationEvents  # noqa: F401 (kept here as the JAX package keeps it)

__all__ = ["IterationEvents", "default_prepare_batch"]


def _to_device(x, device, non_blocking: bool):
    if device is None:
        return x
    if isinstance(x, MetaImage):
        return x.new_like(x.data.to(device, non_blocking=non_blocking))
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=non_blocking)
    return x


def default_prepare_batch(batchdata, device=None, non_blocking: bool = False, **kwargs):
    """(image, label) of a batch dict (label None where it has none), or of an (image,
    label) pair, moved to ``device`` (a MetaImage with its meta)."""
    if not isinstance(batchdata, dict):
        if isinstance(batchdata, (tuple, list)) and len(batchdata) >= 2:
            return _to_device(batchdata[0], device, non_blocking), _to_device(batchdata[1], device, non_blocking)
        return _to_device(batchdata, device, non_blocking), None
    return (_to_device(batchdata[CommonKeys.IMAGE], device, non_blocking),
            _to_device(batchdata.get(CommonKeys.LABEL), device, non_blocking))
