"""Auto3DSeg's data-correction transform ``EnsureSameShaped`` (counterpart of
monai_tpu/apps/auto3dseg/transforms.py)."""
from __future__ import annotations

import warnings
from collections.abc import Hashable, Mapping

import numpy as np

from ...transforms.spatial_array import Resize
from ...transforms.transform import MapTransform
from ...utils.enums import MetaKeys

__all__ = ["EnsureSameShaped"]


class EnsureSameShaped(MapTransform):
    """Resize each of ``keys`` (a label) whose spatial shape differs from ``source_key``'s
    by at most ``allowed_shape_difference`` voxels an axis to the source's shape, by
    nearest neighbours (the separable resample kernel at order 0 on a CUDA label), with a
    warning; raise for a larger difference. Public datasets hold labels a few voxels off
    their images."""

    def __init__(self, keys="label", allow_missing_keys: bool = False, source_key: str = "image",
                 allowed_shape_difference: int = 5, warn: bool = True) -> None:
        super().__init__(keys, allow_missing_keys)
        self.source_key = source_key
        self.allowed_shape_difference = allowed_shape_difference
        self.warn = warn

    def __call__(self, data: Mapping[Hashable, object]) -> dict[Hashable, object]:
        d = dict(data)
        image_shape = tuple(d[self.source_key].shape[1:])
        for key in self.key_iterator(d):
            label_shape = tuple(d[key].shape[1:])
            if label_shape == image_shape:
                continue
            meta = getattr(d[key], "meta", None)
            filename = meta.get(MetaKeys.FILENAME_OR_OBJ, "") if isinstance(meta, Mapping) else ""
            if np.allclose(list(label_shape), list(image_shape), atol=self.allowed_shape_difference):
                if self.warn:
                    warnings.warn(f"The {key} with shape {label_shape} was resized to match the source shape "
                                  f"{image_shape}, the metadata was not updated {filename}.")
                d[key] = Resize(spatial_size=image_shape, mode="nearest")(d[key])
            else:
                raise ValueError(f"The {key} shape {label_shape} is different from the source shape {image_shape} "
                                 f"{filename}.")
        return d
