"""Image writers by file extension (counterpart of monai_tpu/data/image_writer.py:
``ImageWriter``, ``NiftiWriter``, ``register_writer``, ``resolve_writer``).

A writer takes a channel-first tensor on any device, moves its channel last (dropping
it where it has one channel), casts it to ``output_dtype`` and reverses its axes there,
so that the image leaves the device once, as one tensor already in NIfTI's Fortran
order, and is written with ``nifti.write_nifti`` (gzip at its default level 9, as the
JAX package writes it).

With ``resample=True`` the image is resampled from its affine onto the meta's
``original_affine`` before it is written (skipped where the two agree to 1e-5), through
``transforms.SpatialResample`` on its device: the inverse of Orientation and Spacing is a
diagonal map, which runs the separable resample kernel. Unlike the JAX package's writer it
takes the interpolation ``mode`` (``SaveImage``'s, nearest by default, where the JAX
writer resamples a label map bilinearly whatever ``SaveImage`` says) and writes onto the
meta's ``spatial_shape`` where there is one (the JAX writer's is the extent that holds
the input), so a label map comes back onto the input's own grid, as torch MONAI's does.
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
        self.has_channel = False  # data_obj's last axis is a channel
        self.affine = np.eye(4)
        self.resample = False

    def set_data_array(self, data_array: Any, channel_dim: int | None = 0, squeeze_end_dims: bool = True,
                       **kwargs) -> None:
        """The image, channel last (squeezed where it is one channel), on its device."""
        data = data_array.data if isinstance(data_array, MetaImage) else torch.as_tensor(data_array)
        self.has_channel = channel_dim is not None
        if channel_dim is not None:
            data = data.movedim(channel_dim, -1)
            if squeeze_end_dims and data.shape[-1] == 1:
                data = data[..., 0]
                self.has_channel = False
        self.data_obj = data

    def set_metadata(self, meta_dict: dict | None = None, resample: bool = True, mode: str = "nearest",
                     padding_mode: str = "border", **options) -> None:
        """The affine, and where ``resample`` is set the original affine and spatial shape
        to resample onto, with its ``mode`` and ``padding_mode``."""
        meta = meta_dict or {}
        self.affine = np.asarray(meta.get(MetaKeys.AFFINE, np.eye(4)), dtype=np.float64)
        self.original_affine = np.asarray(meta.get(MetaKeys.ORIGINAL_AFFINE, self.affine), dtype=np.float64)
        shape = meta.get(MetaKeys.SPATIAL_SHAPE)
        self.spatial_shape = None if shape is None else tuple(int(v) for v in np.asarray(shape).ravel())
        self.resample, self.mode, self.padding_mode = resample, mode, padding_mode

    def _resampled(self) -> tuple[torch.Tensor, np.ndarray]:
        """The image and affine to write: resampled onto the original affine (and spatial
        shape) where ``resample`` is set and the affines differ, else as they are."""
        if not self.resample or np.allclose(self.affine, self.original_affine, atol=1e-5):
            return self.data_obj, self.affine
        from ..transforms.spatial_array import SpatialResample

        data = self.data_obj.movedim(-1, 0) if self.has_channel else self.data_obj[None]
        out = SpatialResample(mode=self.mode, padding_mode=self.padding_mode)(
            MetaImage(data, affine=self.affine), dst_affine=self.original_affine, spatial_size=self.spatial_shape)
        return (out.data.movedim(0, -1) if self.has_channel else out.data[0]), out.affine

    def write(self, filename, verbose: bool = False, **kwargs) -> None:
        if verbose:
            print(f"writing: {filename}")


class NiftiWriter(ImageWriter):
    """.nii and .nii.gz through ``nifti.write_nifti``, with the affine as the sform."""

    def write(self, filename, verbose: bool = False, **kwargs) -> None:
        super().write(filename, verbose=verbose)
        data, affine = self._resampled()
        data = data if self.output_dtype is None else data.to(get_torch_dtype(self.output_dtype))
        # reversed axes, made contiguous on the device: the host array's transpose is in
        # Fortran order, as the file holds the voxels
        host = data.permute(*reversed(range(data.ndim))).contiguous().cpu().numpy().T
        write_nifti(host, filename, affine=affine)


register_writer("nii.gz", NiftiWriter)
register_writer("nii", NiftiWriter)
register_writer("*", NiftiWriter)
