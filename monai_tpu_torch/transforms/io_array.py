"""LoadImage (counterpart of monai_tpu/transforms/io_array.py; NIfTI files only).

The file is decoded on the host, and its voxels go to the device in the file's own type
(int16 for a CT: half the bytes of float32) and in its Fortran order; the cast to
``dtype`` and the reordering to a C-contiguous (x, y, z) tensor run on the device.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.image_reader import NiftiReader
from ..data.meta_image import MetaImage
from ..utils.backend import get_torch_dtype, resolve_device
from ..utils.enums import MetaKeys
from .transform import Transform

__all__ = ["LoadImage"]


class LoadImage(Transform):
    """Load a NIfTI file into a MetaImage of ``dtype`` on ``device`` (None: the CUDA
    card, see ``utils.backend.resolve_device``)."""

    def __init__(self, dtype=np.float32, device=None):
        self.reader = NiftiReader()
        self.dtype = dtype
        self.device = resolve_device(device)

    def __call__(self, filename: str):
        name = str(Path(filename).expanduser())
        if not self.reader.verify_suffix(name):
            raise RuntimeError(f"{self.__class__.__name__}: {type(self.reader).__name__} cannot read {name}")
        arr, meta = self.reader.get_data(self.reader.read(name))
        # a Fortran-ordered array reversed is C-contiguous: move it as it lies, then order it on the device
        data = torch.from_numpy(np.ascontiguousarray(arr.T)).to(self.device)
        if self.dtype is not None:
            data = data.to(get_torch_dtype(self.dtype))
        data = data.permute(*reversed(range(data.ndim))).contiguous()
        meta[MetaKeys.FILENAME_OR_OBJ] = name
        return MetaImage(data, meta=meta)
