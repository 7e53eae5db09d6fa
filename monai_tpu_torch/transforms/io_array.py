"""LoadImage and SaveImage (counterpart of monai_tpu/transforms/io_array.py; NIfTI
files only).

The file is decoded on the host, and its voxels go to the device in the file's own type
(int16 for a CT: half the bytes of float32) and in its Fortran order; the cast to
``dtype`` and the reordering to a C-contiguous (x, y, z) tensor run on the device. A
saved image takes the opposite way: cast and reordered on its device, then one copy to
the host (``data.image_writer``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..data import image_writer
from ..data.folder_layout import FolderLayout
from ..data.image_reader import NiftiReader
from ..data.meta_image import MetaImage
from ..utils.backend import get_torch_dtype, resolve_device
from ..utils.enums import MetaKeys
from .transform import Transform

__all__ = ["LoadImage", "SaveImage"]


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


class SaveImage(Transform):
    """Write a channel-first image to ``<output_dir>/<subject>/<subject>_<postfix><ext>``
    (``separate_folder``; else without the subject's folder), the subject being the
    file name in the image's ``filename_or_obj`` (else a running index), as
    ``output_dtype``, channel last on disk and squeezed where it is one channel. The
    writer is the first of those registered for ``output_ext`` (or ``writer``) that
    succeeds. With ``resample`` the writer resamples the image onto its meta's original
    affine at ``mode`` and ``padding_mode`` (``data.image_writer``)."""

    def __init__(self, output_dir: str = "./", output_postfix: str = "trans", output_ext: str = ".nii.gz",
                 output_dtype=np.float32, resample: bool = False, mode: str = "nearest", padding_mode: str = "border",
                 squeeze_end_dims: bool = True, data_root_dir: str = "", separate_folder: bool = True,
                 print_log: bool = True, writer=None, folder_layout: FolderLayout | None = None):
        self.folder_layout = folder_layout or FolderLayout(output_dir=output_dir, postfix=output_postfix,
                                                           extension=output_ext, parent=separate_folder,
                                                           makedirs=True, data_root_dir=data_root_dir)
        ext = output_ext.lower()
        self.output_ext = ext if ext.startswith(".") else f".{ext}"
        self.writers = (writer,) if writer is not None else image_writer.resolve_writer(self.output_ext)
        self.output_dtype = output_dtype
        self.resample, self.mode, self.padding_mode = resample, mode, padding_mode
        self.squeeze_end_dims = squeeze_end_dims
        self.print_log = print_log
        self._data_index = 0

    def __call__(self, img: Any, meta_data: dict | None = None, filename: str | None = None):
        meta = img.meta if isinstance(img, MetaImage) else (meta_data or {})
        if filename is None:
            subject = meta.get(MetaKeys.FILENAME_OR_OBJ, str(self._data_index))
            filename = self.folder_layout.filename(subject=f"{subject}", idx=meta.get("patch_index"))
        self._data_index += 1
        errors = []
        for writer_cls in self.writers:
            try:
                writer = writer_cls(output_dtype=self.output_dtype)
                writer.set_data_array(img, channel_dim=0, squeeze_end_dims=self.squeeze_end_dims)
                writer.set_metadata(meta, resample=self.resample, mode=self.mode, padding_mode=self.padding_mode)
                writer.write(filename, verbose=self.print_log)
            except Exception as e:
                errors.append(f"{writer_cls.__name__}: {e!r}")
                continue
            return img
        raise RuntimeError(f"{self.__class__.__name__} cannot find a suitable writer for {filename}: {errors}")
