"""Tuple helpers (counterpart of monai_tpu/utils/misc.py)."""
from __future__ import annotations

import collections.abc
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch

__all__ = ["ensure_tuple", "ensure_tuple_rep", "ensure_tuple_size", "fall_back_tuple", "first",
           "issequenceiterable"]


def issequenceiterable(obj: Any) -> bool:
    """True for iterables that are not strings or 0-d arrays/tensors."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.ndim > 0
    return isinstance(obj, collections.abc.Iterable) and not isinstance(obj, (str, bytes))


def ensure_tuple(vals: Any) -> tuple:
    """Wrap ``vals`` into a tuple."""
    return tuple(vals) if issequenceiterable(vals) else (vals,)


def ensure_tuple_size(vals: Any, dim: int, pad_val: Any = 0, pad_from_start: bool = False) -> tuple:
    """Pad or cut ``vals`` to length ``dim``."""
    new = ensure_tuple(vals)
    if pad_from_start:
        new = (pad_val,) * dim + new
        return new[-dim:]
    return (new + (pad_val,) * dim)[:dim]


def ensure_tuple_rep(tup: Any, dim: int) -> tuple:
    """Return a tuple of length ``dim``, repeating a scalar."""
    if isinstance(tup, (int, float)) or not issequenceiterable(tup):
        return (tup,) * dim
    t = tuple(tup)
    if len(t) == dim:
        return t
    raise ValueError(f"Sequence must have length {dim}, got {len(t)}.")


def fall_back_tuple(user_provided: Any, default: Sequence, func: Callable = lambda x: x and x > 0) -> tuple:
    """Take ``user_provided`` elementwise, falling back to ``default`` where ``func`` is
    False (e.g. a roi size of -1 becomes the image size)."""
    ndim = len(ensure_tuple(default))
    user = ensure_tuple_rep(user_provided, ndim)
    return tuple(u if func(u) else d for u, d in zip(user, ensure_tuple(default)))


def first(iterable, default=None):
    """The first item of ``iterable``, or ``default`` when it is empty."""
    for i in iterable:
        return i
    return default
