"""EnsureChannelFirst (counterpart of monai_tpu/transforms/utility_array.py)."""
from __future__ import annotations

from typing import Any

from ..data.meta_image import MetaImage
from ..utils.enums import MetaKeys
from .transform import Transform

__all__ = ["EnsureChannelFirst"]


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
