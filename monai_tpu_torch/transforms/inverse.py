"""Transform tracing and inversion (counterpart of monai_tpu/transforms/inverse.py).

A spatial transform records a pending operation (its output-to-input voxel matrix,
output shape and resample settings), and the flush (``lazy_executor.apply_pending``)
moves it onto the image's applied stack. ``InvertibleTransform.inverse`` pops the most
recent applied record of its own class and resamples with the inverse matrix back onto
the recorded input size. Affine math is float64 numpy on the host.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np

from ..data.affine_utils import to_affine_nd
from ..data.meta_image import MetaImage
from ..utils.enums import LazyAttr, TraceKeys
from .lazy_utils import pending_op, resample
from .transform import Transform

__all__ = ["TraceableTransform", "InvertibleTransform"]


class TraceableTransform(Transform):
    """Keeps the applied and pending operation stacks of a MetaImage."""

    def push_transform(self, data: MetaImage, matrix: np.ndarray, sp_size, orig_size, extra_info: dict,
                       mode=None, padding_mode=None, align_corners=None, dtype=None) -> MetaImage:
        """Record a pending operation of this transform on ``data``: its output-to-input
        voxel ``matrix``, output shape ``sp_size``, input shape and resample settings."""
        op = pending_op(matrix, sp_size, mode=mode, padding_mode=padding_mode, align_corners=align_corners,
                        dtype=dtype)
        op[TraceKeys.CLASS_NAME] = self.__class__.__name__
        op[TraceKeys.ID] = id(self)
        op[TraceKeys.ORIG_SIZE] = tuple(int(s) for s in orig_size)
        op[TraceKeys.EXTRA_INFO] = extra_info
        data.push_pending_operation(op)
        return data

    def check_transforms_match(self, transform: Mapping) -> None:
        if transform.get(TraceKeys.CLASS_NAME) != self.__class__.__name__:
            raise RuntimeError(f"Error inverting the most recently applied invertible transform "
                               f"{transform.get(TraceKeys.CLASS_NAME)}, expected {self.__class__.__name__}.")

    def get_most_recent_transform(self, data, pop: bool = False, check: bool = True):
        if not isinstance(data, MetaImage) or not data.applied_operations:
            raise RuntimeError("no applied operations found")
        t = data.applied_operations[-1]
        if check:
            self.check_transforms_match(t)
        if pop:
            data.pop_applied_operation()
        return t


class InvertibleTransform(TraceableTransform):
    """A transform that can undo its applied operation: resample with the inverse matrix
    back onto the recorded input size, where the data lies."""

    def inverse(self, data: Any) -> Any:
        if not isinstance(data, MetaImage):
            raise NotImplementedError(f"inverse of {self.__class__.__name__} requires MetaImage input")
        data = data.new_like(data.data)  # the caller's image and its stack stay as they are
        t = self.get_most_recent_transform(data, pop=True)
        matrix = t.get(TraceKeys.AFFINE)
        if matrix is None:
            raise NotImplementedError(f"{self.__class__.__name__} recorded no affine; cannot auto-invert")
        kwargs = {LazyAttr.SHAPE: t[TraceKeys.ORIG_SIZE], LazyAttr.INTERP_MODE: t.get(LazyAttr.INTERP_MODE, 1),
                  LazyAttr.PADDING_MODE: t.get(LazyAttr.PADDING_MODE, "zeros"),
                  LazyAttr.ALIGN_CORNERS: t.get(LazyAttr.ALIGN_CORNERS, False)}
        out = data.new_like(resample(data.data, np.linalg.inv(np.asarray(matrix, dtype=np.float64)), kwargs))
        out.affine = np.asarray(out.affine, dtype=np.float64) @ np.linalg.inv(to_affine_nd(len(out.affine) - 1, matrix))
        return out
