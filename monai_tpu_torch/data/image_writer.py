"""Image writers by file extension (counterpart of monai_tpu/data/image_writer.py:
``ImageWriter``, ``NiftiWriter``, ``register_writer``, ``resolve_writer``).

A writer takes a channel-first tensor on any device, moves its channel last (dropping
it where it has one channel), casts it to ``output_dtype`` and reverses its axes there,
so that the image leaves the device once, as one tensor already in NIfTI's Fortran
order, and is written with ``nifti.write_nifti`` (gzip at its default level 9, as the
JAX package writes it). Resampling to the original affine on write (``resample=True``)
is not ported: the Spleen bundle saves after ``Invertd``, with ``resample`` false.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.backend import get_torch_dtype
from ..utils.enums import MetaKeys
from .meta_image import MetaImage
from .nifti import write_nifti

__all__ = ["ImageWriter", "NiftiWriter", "SUPPORTED_WRITERS", "register_writer", "resolve_writer"]

SUPPORTED_WRITERS: dict[str, tuple] = {}


def _ext(ext_name: str) -> str:
    fmt = f"{ext_name}".lower()
    return fmt[1:] if fmt.startswith(".") else fmt


def register_writer(ext_name: str, *im_writers) -> None:
    """Register writer classes for a file extension, ahead of those already there;
    ``"*"`` is the fallback for any extension."""
    fmt = _ext(ext_name)
    SUPPORTED_WRITERS[fmt] = im_writers + SUPPORTED_WRITERS.get(fmt, ())


def resolve_writer(ext_name: str, error_if_not_found: bool = True) -> tuple:
    """The writer classes for an extension, to try in order."""
    writers = SUPPORTED_WRITERS.get(_ext(ext_name), SUPPORTED_WRITERS.get("*", ()))
    if not writers and error_if_not_found:
        raise OSError(f"No ImageWriter backend found for {ext_name}.")
    return tuple(writers)


class ImageWriter:
    """``set_data_array``, ``set_metadata``, then ``write(filename)``."""

    def __init__(self, output_dtype=np.float32):
        self.output_dtype = output_dtype
        self.data_obj: torch.Tensor | None = None
        self.affine = np.eye(4)

    def set_data_array(self, data_array: Any, channel_dim: int | None = 0, squeeze_end_dims: bool = True,
                       **kwargs) -> None:
        """The image, channel last (squeezed where it is one channel), on its device."""
        data = data_array.data if isinstance(data_array, MetaImage) else torch.as_tensor(data_array)
        if channel_dim is not None:
            data = data.movedim(channel_dim, -1)
            if squeeze_end_dims and data.shape[-1] == 1:
                data = data[..., 0]
        self.data_obj = data

    def set_metadata(self, meta_dict: dict | None = None, resample: bool = False, **options) -> None:
        if resample:
            raise NotImplementedError("resampling on write is not ported; invert the image first (Invertd)")
        self.affine = np.asarray((meta_dict or {}).get(MetaKeys.AFFINE, np.eye(4)), dtype=np.float64)

    def write(self, filename, verbose: bool = False, **kwargs) -> None:
        if verbose:
            print(f"writing: {filename}")


class NiftiWriter(ImageWriter):
    """.nii and .nii.gz through ``nifti.write_nifti``, with the affine as the sform."""

    def write(self, filename, verbose: bool = False, **kwargs) -> None:
        super().write(filename, verbose=verbose)
        data = self.data_obj if self.output_dtype is None else self.data_obj.to(get_torch_dtype(self.output_dtype))
        # reversed axes, made contiguous on the device: the host array's transpose is in
        # Fortran order, as the file holds the voxels
        host = data.permute(*reversed(range(data.ndim))).contiguous().cpu().numpy().T
        write_nifti(host, filename, affine=self.affine)


register_writer("nii.gz", NiftiWriter)
register_writer("nii", NiftiWriter)
register_writer("*", NiftiWriter)
