"""The flush of pending operations (counterpart of monai_tpu/transforms/lazy_executor.py):
compose a MetaImage's pending operations into as few resamples as their settings allow,
run them on the data's device, and move the operations onto the applied stack."""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any

from ..data.affine_utils import to_affine_nd
from ..data.meta_image import MetaImage
from ..utils.enums import LazyAttr, TraceKeys
from .lazy_utils import (affine_from_pending, combine_transforms, is_compatible_apply_kwargs, kwargs_from_pending,
                         resample)
from .traits import LazyTrait

__all__ = ["apply_pending", "apply_pending_transforms", "apply_pending_transforms_in_order",
           "promote_pending_with_data"]


def apply_pending(data: Any, pending: list | None = None):
    """Compose and run the pending operations of ``data`` (or ``pending``) with as few
    resamples as possible; returns (result, the operations applied)."""
    if isinstance(data, MetaImage) and pending is None:
        pending = list(data.pending_operations)
    pending = [] if pending is None else list(pending)
    if not pending:
        return data, []
    cumulative = affine_from_pending(pending[0])
    if cumulative.shape[0] == 3 and isinstance(data, MetaImage) and len(data.shape) == 4:
        cumulative = to_affine_nd(3, cumulative)  # a 2-D matrix on 3-D data
    cur_kwargs = kwargs_from_pending(pending[0])
    img_data = data.data if isinstance(data, MetaImage) else data
    for p in pending[1:]:
        new_kwargs = kwargs_from_pending(p)
        if not is_compatible_apply_kwargs(cur_kwargs, new_kwargs):  # settings change: flush what came before
            img_data = resample(img_data, cumulative, cur_kwargs)
            cumulative = affine_from_pending(p)
        else:
            nxt = affine_from_pending(p)
            if nxt.shape != cumulative.shape:
                r = max(len(nxt), len(cumulative)) - 1
                nxt, cumulative = to_affine_nd(r, nxt), to_affine_nd(r, cumulative)
            cumulative = combine_transforms(cumulative, nxt)
        cur_kwargs.update(new_kwargs)
    img_data = resample(img_data, cumulative, cur_kwargs)
    if isinstance(data, MetaImage):
        return promote_pending_with_data(data, img_data), pending
    return img_data, pending


def promote_pending_with_data(data: MetaImage, img_data) -> MetaImage:
    """A MetaImage holding the flushed ``img_data``, its affine updated, its pending
    operations moved onto the applied stack so that the chain stays invertible."""
    out = data.new_like(img_data)
    out.affine = data.peek_pending_affine()
    out.clear_pending_operations()
    for p in data.pending_operations:
        out.push_applied_operation({
            TraceKeys.CLASS_NAME: p.get(TraceKeys.CLASS_NAME, "Lazy"),
            TraceKeys.ID: p.get(TraceKeys.ID, -1),
            TraceKeys.ORIG_SIZE: p.get(TraceKeys.ORIG_SIZE),
            TraceKeys.EXTRA_INFO: p.get(TraceKeys.EXTRA_INFO, {}),
            TraceKeys.AFFINE: p[LazyAttr.AFFINE],
            LazyAttr.SHAPE: p.get(LazyAttr.SHAPE),
            LazyAttr.INTERP_MODE: p.get(LazyAttr.INTERP_MODE),
            LazyAttr.PADDING_MODE: p.get(LazyAttr.PADDING_MODE),
            LazyAttr.ALIGN_CORNERS: p.get(LazyAttr.ALIGN_CORNERS),
        })
    return out


def apply_pending_transforms(data: Any, keys: Sequence | None = None):
    """Flush the pending operations of a MetaImage, or of those in a list, tuple or dict."""
    if isinstance(data, (list, tuple)):
        return type(data)(apply_pending_transforms(d, keys) for d in data)
    if isinstance(data, dict):
        out = dict(data)
        for k in data:
            if (keys is None or k in keys) and isinstance(out[k], MetaImage) and out[k].pending_operations:
                out[k], _ = apply_pending(out[k])
        return out
    if isinstance(data, MetaImage) and data.pending_operations:
        return apply_pending(data)[0]
    return data


def apply_pending_transforms_in_order(transform: Any, data: Any, lazy: bool | None = None):
    """Flush pending operations before ``transform`` unless it runs lazily (``lazy``, else
    its own setting) and needs no current data (then its own operation joins the pending
    ones)."""
    from .compose import Compose

    if isinstance(transform, Compose):
        return data  # a Compose flushes for itself
    if isinstance(transform, LazyTrait) and (transform.lazy if lazy is None else lazy) \
            and not transform.requires_current_data:
        return data
    return apply_pending_transforms(data)
