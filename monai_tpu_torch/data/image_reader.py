"""The NIfTI image reader (counterpart of monai_tpu/data/image_reader.py::NiftiReader)."""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from ..utils.enums import MetaKeys, SpaceKeys
from .nifti import read_nifti

__all__ = ["NiftiReader"]


class NiftiReader:
    """One .nii or .nii.gz file through ``nifti.read_nifti``, in the file's own type:
    ``LoadImage`` casts after moving the data to its device."""

    def verify_suffix(self, filename: Any) -> bool:
        return "".join(Path(str(filename).lower()).suffixes).endswith((".nii", ".nii.gz"))

    def read(self, filename: Any) -> tuple[np.ndarray, dict]:
        return read_nifti(filename)

    def get_data(self, img: tuple[np.ndarray, dict]) -> tuple[np.ndarray, dict]:
        """The voxels and the metadata that LoadImage and EnsureChannelFirst read."""
        arr, meta = img
        header = dict(meta)
        header[MetaKeys.AFFINE] = meta["affine"].copy()
        header[MetaKeys.ORIGINAL_AFFINE] = meta["affine"].copy()
        header[MetaKeys.SPACE] = SpaceKeys.RAS
        header[MetaKeys.ORIGINAL_CHANNEL_DIM] = "no_channel" if arr.ndim == len(meta["spatial_shape"]) else -1
        return arr, header
