"""NIfTI-1 reader and writer in numpy and gzip alone (counterpart of
monai_tpu/data/nifti.py): the 348-byte header, the optional gzip container, and the
sform/qform affines in the RAS+ world convention. The data stays in the file's
Fortran (x, y, z, ...) order; the affine is float64 on the host.
"""
from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["read_nifti", "write_nifti"]

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64, 256: np.int8,
           512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _affine(sform_code: int, srow: np.ndarray, qform_code: int, quatern, qoffset, pixdim) -> np.ndarray:
    """World affine (RAS+): the sform if set, else the qform, else the pixdim diagonal."""
    if sform_code > 0:
        aff = np.eye(4, dtype=np.float64)
        aff[:3] = srow
        return aff
    if qform_code > 0:
        b, c, d = quatern
        a = np.sqrt(max(1.0 - (b * b + c * c + d * d), 0.0))
        rot = np.array([
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ])
        qfac = -1.0 if pixdim[0] == -1 else 1.0
        aff = np.eye(4, dtype=np.float64)
        aff[:3, :3] = rot * np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        aff[:3, 3] = qoffset
        return aff
    return np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0]).astype(np.float64)


def _open(path: Path, mode: str):
    return gzip.open(path, mode) if str(path).endswith(".gz") else open(path, mode)


def read_nifti(filename: Any, dtype=None) -> tuple[np.ndarray, dict]:
    """Read a .nii or .nii.gz file: (data in the file's type and Fortran axis order,
    meta dict with ``affine``, ``original_affine``, ``spatial_shape``, ``pixdim``,
    ``filename_or_obj`` and ``space``). ``dtype`` casts the data."""
    with _open(Path(filename), "rb") as f:
        raw = bytearray(f.read())  # writable, so the voxels can back a tensor without a copy
    if len(raw) < 348:
        raise ValueError(f"File too short to be NIfTI-1: {filename}")
    endian = "<"
    if struct.unpack("<i", raw[:4])[0] != 348:
        if struct.unpack(">i", raw[:4])[0] != 348:
            raise ValueError(f"Not a NIfTI-1 file: {filename}")
        endian = ">"
    if raw[344:347] not in (b"n+1", b"ni1"):
        raise ValueError(f"Bad NIfTI magic {raw[344:348]!r}: {filename}")

    def field(fmt: str, offset: int):
        return struct.unpack_from(endian + fmt, raw, offset)

    dim = field("8h", 40)
    datatype = field("h", 70)[0]
    pixdim = field("8f", 76)
    vox_offset = field("f", 108)[0]
    scl_slope, scl_inter = field("2f", 112)
    qform_code, sform_code = field("2h", 252)
    srow = np.asarray(field("12f", 280), dtype=np.float64).reshape(3, 4)
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}: {filename}")
    shape = tuple(int(d) for d in dim[1:1 + dim[0]])
    data = np.frombuffer(raw, dtype=np.dtype(_DTYPES[datatype]).newbyteorder(endian),
                         count=int(np.prod(shape)) if shape else 0, offset=int(vox_offset))
    data = data.reshape(shape, order="F")  # NIfTI stores voxels in Fortran order
    if data.dtype.byteorder not in ("=", "|"):  # a big-endian file on this host
        data = data.astype(data.dtype.newbyteorder("="))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        data = data * (scl_slope if scl_slope != 0.0 else 1.0) + scl_inter
    data = data.astype(dtype) if dtype is not None else np.asarray(data)
    affine = _affine(sform_code, srow, qform_code, field("3f", 256), field("3f", 268), pixdim)
    meta = {
        "affine": affine.copy(),
        "original_affine": affine.copy(),
        "spatial_shape": np.asarray(shape[:3] if len(shape) >= 3 else shape),
        "pixdim": np.asarray(pixdim[1:1 + len(shape)]),
        "filename_or_obj": str(filename),
        "space": "RAS",
    }
    return data, meta


def write_nifti(data: np.ndarray, filename: Any, affine: np.ndarray | None = None, dtype=None) -> None:
    """Write an array to .nii or .nii.gz with an sform affine (RAS+)."""
    arr = np.asarray(data)
    if dtype is not None:
        arr = arr.astype(dtype)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if np.dtype(arr.dtype) not in _DTYPE_CODES:
        arr = arr.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, dtype=np.float64)
    if affine.shape != (4, 4):
        full = np.eye(4)
        d = min(affine.shape[0] - 1, 3)
        full[:d, :d] = affine[:d, :d]
        full[:d, 3] = affine[:d, -1]
        affine = full
    ndim = arr.ndim
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, ndim, *arr.shape, *[1] * (7 - ndim))
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(arr.dtype)])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms[:min(3, ndim)], *[1.0] * (7 - min(3, ndim)))
    struct.pack_into("<3f", hdr, 108, 352.0, 1.0, 0.0)  # vox_offset, scl_slope, scl_inter
    hdr[148:157] = b"monai_tpu"
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code 0, sform_code 1 (scanner anatomical)
    struct.pack_into("<12f", hdr, 280, *affine[:3].reshape(-1).tolist())
    hdr[344:348] = b"n+1\0"
    with _open(Path(filename), "wb") as f:
        f.write(bytes(hdr) + b"\0\0\0\0" + np.asfortranarray(arr).tobytes(order="F"))
