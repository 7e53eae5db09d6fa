"""EnsureChannelFirst, ConvertToMultiChannelBasedOnBratsClasses and FgBgToIndices
(counterpart of monai_tpu/transforms/utility_array.py)."""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np
import torch

from ..data.meta_image import MetaImage
from ..utils.enums import MetaKeys
from .transform import Transform
from .utils import map_binary_to_indices

__all__ = ["ConvertToMultiChannelBasedOnBratsClasses", "EnsureChannelFirst", "FgBgToIndices"]


class EnsureChannelFirst(Transform):
    """Move the channel axis first, or add one, as the MetaImage's
    ``original_channel_dim`` (or ``channel_dim``) says."""

    def __init__(self, channel_dim: None | str | int = None):
        self.input_channel_dim = channel_dim

    def __call__(self, img: Any):
        meta = img.meta if isinstance(img, MetaImage) else {}
        channel_dim = self.input_channel_dim
        if channel_dim is None:
            channel_dim = meta.get(MetaKeys.ORIGINAL_CHANNEL_DIM)
        if channel_dim is None:
            raise ValueError("Unknown original_channel_dim in the MetaImage meta dict or `channel_dim`.")
        data = img.data if isinstance(img, MetaImage) else img
        out = data[None] if channel_dim == "no_channel" else data.movedim(int(channel_dim), 0)
        if isinstance(img, MetaImage):
            res = img.new_like(out)
            res.meta[MetaKeys.ORIGINAL_CHANNEL_DIM] = channel_dim
            return res
        return out


class ConvertToMultiChannelBasedOnBratsClasses(Transform):
    """A BraTS label map (1 the necrotic and non-enhancing tumour core, 2 the oedema, 4 or 3
    the enhancing tumour; a leading channel of 1 is dropped) as three channels: the tumour
    core (1, 3, 4), the whole tumour (1, 2, 3, 4) and the enhancing tumour (3, 4). A tensor
    comes out in its own type, a numpy array as float32."""

    def __call__(self, img: Any):
        data = img.data if isinstance(img, MetaImage) else img
        if data.ndim == 4 and data.shape[0] == 1:
            data = data[0]
        core = (data == 1) | (data == 4) | (data == 3)
        whole = core | (data == 2)
        enhancing = (data == 4) | (data == 3)
        if isinstance(data, np.ndarray):
            out = np.stack([core, whole, enhancing]).astype(np.float32)
        else:
            out = torch.stack([core, whole, enhancing]).to(data.dtype)
        return img.new_like(out) if isinstance(img, MetaImage) else out


class FgBgToIndices(Transform):
    """The flat indices of a label's foreground and background voxels
    (``map_binary_to_indices``), as ``RandCropByPosNegLabel`` takes them; with
    ``output_shape``, each index as its coordinates in that shape."""

    def __init__(self, image_threshold: float = 0.0, output_shape: Sequence[int] | None = None):
        self.image_threshold = image_threshold
        self.output_shape = output_shape

    def __call__(self, label: Any, image: Any = None, output_shape=None) -> tuple[np.ndarray, np.ndarray]:
        shape = self.output_shape if output_shape is None else output_shape
        fg, bg = map_binary_to_indices(label, image, self.image_threshold)
        if shape is not None:
            fg, bg = (np.stack(np.unravel_index(i, shape), axis=-1) for i in (fg, bg))
        return fg, bg
