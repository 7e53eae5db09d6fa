"""MetaImage: a tensor, its affine, its metadata and its transform trace (counterpart
of monai_tpu/data/meta_image.py).

As in the JAX package, MetaImage is a thin wrapper and not a tensor subclass:

- ``data``: a channel-first ``torch.Tensor`` on any device. Only this reaches the
  network; every transform on the path keeps it where it is.
- ``affine``: a float64 numpy (D+1, D+1) matrix, always on the host.
- ``meta``: a plain dict (filename, original affine, spatial shape, ...).
- ``applied_operations`` and ``pending_operations``: the stacks that make the spatial
  transforms invertible and let pending operations fuse into one resample.
- ``is_batch``: True for a collated batch (``data.utils.list_data_collate``), whose
  ``data`` is (B, C, ...), ``affine`` (B, D+1, D+1), ``meta["batched_meta"]`` and
  ``applied_operations`` a list with one entry per item, until ``decollate_batch``
  gives the items back.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.backend import to_numpy
from ..utils.enums import MetaKeys, SpaceKeys
from .affine_utils import to_affine_nd

__all__ = ["MetaImage"]


class MetaImage:
    """Tensor with affine, metadata and transform trace; see the module docstring."""

    def __init__(self, data: Any, affine: np.ndarray | None = None, meta: dict | None = None,
                 applied_operations: list | None = None, pending_operations: list | None = None,
                 is_batch: bool = False):
        if isinstance(data, MetaImage):
            affine = data.affine if affine is None else affine
            meta = dict(data.meta) if meta is None else meta
            applied_operations = list(data.applied_operations) if applied_operations is None else applied_operations
            pending_operations = list(data.pending_operations) if pending_operations is None else pending_operations
            is_batch = is_batch or data.is_batch
            data = data.data
        self.data: torch.Tensor = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data))
        self.meta: dict = dict(meta) if meta else {}
        if affine is not None:
            aff = np.asarray(affine, dtype=np.float64)
        elif MetaKeys.AFFINE in self.meta:
            aff = np.asarray(self.meta[MetaKeys.AFFINE], dtype=np.float64)
        else:
            aff = np.eye(max(self.data.ndim - 1, 1) + 1, dtype=np.float64)
        self.meta[MetaKeys.AFFINE] = aff
        self.meta.setdefault(MetaKeys.SPACE, SpaceKeys.RAS)
        self.applied_operations: list = list(applied_operations) if applied_operations else []
        self.pending_operations: list = list(pending_operations) if pending_operations else []
        self.is_batch = is_batch

    @property
    def affine(self) -> np.ndarray:
        return self.meta[MetaKeys.AFFINE]

    @affine.setter
    def affine(self, value) -> None:
        self.meta[MetaKeys.AFFINE] = np.asarray(value, dtype=np.float64)

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def peek_pending_shape(self) -> tuple:
        """Spatial shape after all pending operations."""
        res = self.pending_operations[-1].get("lazy_shape") if self.pending_operations else None
        return tuple(self.data.shape[1:]) if res is None else tuple(int(x) for x in res)

    def peek_pending_affine(self) -> np.ndarray:
        """Affine after all pending operations."""
        res = np.asarray(self.affine, dtype=np.float64)
        r = len(res) - 1
        for p in self.pending_operations:
            next_matrix = p.get("lazy_affine")
            if next_matrix is not None:
                res = res @ to_affine_nd(r, np.asarray(next_matrix, dtype=np.float64))
        return res

    def push_pending_operation(self, op: dict) -> None:
        self.pending_operations.append(op)

    def clear_pending_operations(self) -> None:
        self.pending_operations = []

    def push_applied_operation(self, op: dict) -> None:
        self.applied_operations.append(op)

    def pop_applied_operation(self) -> dict:
        return self.applied_operations.pop()

    def as_numpy(self, dtype=None) -> np.ndarray:
        return to_numpy(self.data, dtype=dtype)

    def new_like(self, data: Any) -> "MetaImage":
        """A MetaImage holding ``data`` and a shallow copy of this one's metadata."""
        return MetaImage(data, affine=np.array(self.affine), meta=dict(self.meta),
                         applied_operations=list(self.applied_operations),
                         pending_operations=list(self.pending_operations), is_batch=self.is_batch)

    @staticmethod
    def ensure_meta(img: Any) -> "MetaImage":
        return img if isinstance(img, MetaImage) else MetaImage(img)

    def __repr__(self) -> str:
        return (f"MetaImage(shape={self.shape}, dtype={self.data.dtype}, device={self.data.device},\n"
                f" affine=\n{self.affine},\n pending={len(self.pending_operations)}, "
                f"applied={len(self.applied_operations)})")
