"""Patch grids and importance maps for sliding-window inference, and the collation of
items into batches and back (counterpart of the same functions in
monai_tpu/data/utils.py). The grid is Python ints on the host, the importance map is
computed with numpy in float32 and handed over as a tensor; a batch stays on its
items' device. ``pickle_hashing`` is the content hash ``CacheDataset(hash_as_key=True)``
keys its items by."""
from __future__ import annotations

import hashlib
import math
import pickle
from collections.abc import Iterable, Mapping, Sequence
from copy import deepcopy
from itertools import zip_longest
from typing import Any

import numpy as np
import torch

from ..utils.enums import BlendMode
from ..utils.misc import ensure_tuple_rep, ensure_tuple_size, first
from .meta_image import MetaImage

__all__ = ["collate_meta_tensor", "compute_importance_map", "decollate_batch", "dense_patch_slices",
           "get_valid_patch_size", "list_data_collate", "pickle_hashing"]


def get_valid_patch_size(image_size: Sequence[int], patch_size: Sequence[int] | int) -> tuple:
    """Clamp ``patch_size`` to ``image_size``; a patch size of 0 or None means the whole dim."""
    patch_size_ = ensure_tuple_size(patch_size, len(image_size))
    return tuple(min(ms, ps if ps is not None and ps > 0 else ms) for ms, ps in zip(image_size, patch_size_))


def dense_patch_slices(image_size: Sequence[int], patch_size: Sequence[int],
                       scan_interval: Sequence[int], return_slice: bool = True) -> list:
    """All windows of a sliding scan over ``image_size``, in row-major order, the last
    window of each dim pulled back to end at the image border."""
    num_spatial_dims = len(image_size)
    patch_size = get_valid_patch_size(image_size, patch_size)
    scan_interval = ensure_tuple_size(scan_interval, num_spatial_dims)

    scan_num = []
    for i in range(num_spatial_dims):
        if scan_interval[i] == 0:
            scan_num.append(1)
        else:
            num = int(math.ceil(float(image_size[i]) / scan_interval[i]))
            scan_dim = first(d for d in range(num) if d * scan_interval[i] + patch_size[i] >= image_size[i])
            scan_num.append(scan_dim + 1 if scan_dim is not None else 1)

    starts = []
    for dim in range(num_spatial_dims):
        dim_starts = []
        for idx in range(scan_num[dim]):
            start_idx = idx * scan_interval[dim]
            start_idx -= max(start_idx + patch_size[dim] - image_size[dim], 0)
            dim_starts.append(start_idx)
        starts.append(dim_starts)
    out = np.asarray([x.flatten() for x in np.meshgrid(*starts, indexing="ij")]).T
    if return_slice:
        return [tuple(slice(int(s), int(s) + patch_size[d]) for d, s in enumerate(x)) for x in out]
    return [tuple((int(s), int(s) + patch_size[d]) for d, s in enumerate(x)) for x in out]


def compute_importance_map(patch_size: Sequence[int], mode: str = BlendMode.CONSTANT,
                           sigma_scale: Sequence[float] | float = 0.125, device=None,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Blend weights for window stitching. ``gaussian``: a separable centred Gaussian with
    sigma = sigma_scale * size per dim, not renormalised, min-clamped at its smallest
    value or 1e-3, whichever is larger, so no voxel gets zero weight."""
    if str(mode) == str(BlendMode.CONSTANT):
        return torch.ones(tuple(patch_size), dtype=dtype, device=device)
    if str(mode) != str(BlendMode.GAUSSIAN):
        raise ValueError(f"Unsupported mode: {mode}, available options are ['constant', 'gaussian'].")
    sigma_scale_ = ensure_tuple_rep(sigma_scale, len(patch_size))
    out = np.ones(tuple(patch_size), dtype=np.float32)
    for d, (size, s) in enumerate(zip(patch_size, sigma_scale_)):
        sigma = size * s
        x = np.arange(-(size - 1) / 2.0, (size - 1) / 2.0 + 1, dtype=np.float32)
        g = np.exp(x ** 2 / np.float32(-2 * sigma ** 2))
        shape = [1] * len(patch_size)
        shape[d] = size
        out = out * g.reshape(shape)
    out = np.clip(out, a_min=max(float(out.min()), 1e-3), a_max=None)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def collate_meta_tensor(batch: Sequence) -> Any:
    """Stack a list of items into a batch: MetaImages into one MetaImage with
    ``is_batch`` set (data stacked on their device, affines stacked, each item's meta and
    applied operations kept in a list), tensors and arrays stacked, numbers into a
    tensor, dicts and sequences element by element, anything else as a list. The batch
    is a copy, whatever its size: a change to it never reaches an item."""
    elem = batch[0]
    if isinstance(elem, MetaImage):
        return MetaImage(torch.stack([e.data for e in batch]), affine=np.stack([np.asarray(e.affine) for e in batch]),
                         meta={"batched_meta": [dict(e.meta) for e in batch]},
                         applied_operations=[list(e.applied_operations) for e in batch], is_batch=True)
    if isinstance(elem, (torch.Tensor, np.ndarray)):
        return torch.stack([torch.as_tensor(e) for e in batch])
    if isinstance(elem, (bool, int, float, np.number)):
        return torch.as_tensor(batch)
    if isinstance(elem, Mapping):
        return {k: collate_meta_tensor([d[k] for d in batch]) for k in elem}
    if isinstance(elem, (tuple, list)):
        return [collate_meta_tensor([d[i] for d in batch]) for i in range(len(elem))]
    return list(batch)


def list_data_collate(batch: Sequence) -> Any:
    """Collate a list of items (a list of lists, as multi-sample transforms give, is
    flattened one level first)."""
    data = [i for k in batch for i in k] if isinstance(first(batch), list) else list(batch)
    return collate_meta_tensor(data) if data else data


def decollate_batch(batch: Any, detach: bool = True, pad: bool = True, fill_value: Any = None) -> Any:
    """A batch as the list of its items, the inverse of ``list_data_collate``: a batched
    MetaImage gives MetaImages with their own affine, meta and applied operations (each
    a view of the batch's data, on its device); a tensor its rows (0-d ones as numbers
    where ``detach``); a dict or sequence one dict or list per item, where values that
    are not batched (None, a string) are repeated for each item with ``pad``, and
    shorter ones filled with ``fill_value``. A single item, or a number, comes back as
    it is."""
    if batch is None or isinstance(batch, (float, int, str, bytes)):
        return batch
    if isinstance(batch, MetaImage):
        if not batch.is_batch:
            return batch
        data = batch.data.detach() if detach else batch.data
        n = data.shape[0]
        affines = np.asarray(batch.affine)
        metas = batch.meta.get("batched_meta", [{}] * n)
        ops = batch.applied_operations if len(batch.applied_operations) == n else [[]] * n
        return [MetaImage(data[i], affine=affines[i] if affines.ndim == 3 else affines, meta=dict(metas[i]),
                          applied_operations=list(ops[i])) for i in range(n)]
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        t = torch.as_tensor(batch)
        t = t.detach() if detach else t
        if t.ndim == 0:
            return t.item() if detach else t
        return [x.item() if detach and x.ndim == 0 else x for x in t.unbind(0)]
    if isinstance(batch, Mapping):
        deco: dict | list = {k: decollate_batch(v, detach, pad, fill_value) for k, v in batch.items()}
    elif isinstance(batch, Iterable):
        deco = [decollate_batch(b, detach, pad, fill_value) for b in batch]
    else:
        raise NotImplementedError(f"Unable to de-collate: {batch}, type: {type(batch)}.")
    entries = deco.items() if isinstance(deco, dict) else enumerate(deco)
    lists = {k: isinstance(v, (list, tuple)) for k, v in entries}
    size = max((len(deco[k]) for k, is_list in lists.items() if is_list), default=0)
    if size == 0:
        return deco  # a single item: nothing in it is batched
    if pad:
        for k, is_list in lists.items():
            if not is_list:
                deco[k] = [deepcopy(deco[k]) for _ in range(size)]
    columns = list(deco.values()) if isinstance(deco, dict) else deco
    rows = zip_longest(*columns, fillvalue=fill_value) if pad else zip(*columns)
    return [dict(zip(deco, row)) for row in rows] if isinstance(deco, dict) else [list(row) for row in rows]


def pickle_hashing(item, protocol=pickle.HIGHEST_PROTOCOL) -> bytes:
    """A content hash of ``item``: the md5 of its pickle, its dicts' keys sorted and its
    tensors as numpy arrays (a tensor's own pickle differs between equal tensors)."""
    return hashlib.md5(pickle.dumps(_hashable(item), protocol=protocol), usedforsecurity=False).hexdigest().encode()


def _hashable(item):
    if isinstance(item, torch.Tensor):
        return item.detach().cpu().numpy()
    if not isinstance(item, dict):
        return item
    return {k: _hashable(v) for k, v in sorted(item.items())}
