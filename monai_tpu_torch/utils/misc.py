"""Tuple helpers and the seeds (counterpart of monai_tpu/utils/misc.py)."""
from __future__ import annotations

import collections.abc
import random
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch

__all__ = ["ensure_tuple", "ensure_tuple_rep", "ensure_tuple_size", "fall_back_tuple", "first", "get_seed",
           "issequenceiterable", "set_determinism"]

_MAX_SEED = np.iinfo(np.uint32).max + 1
_seed: int | None = None


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


def set_determinism(seed: int | None = _MAX_SEED - 1, use_deterministic_algorithms: bool | None = None,
                    additional_settings: Callable | Sequence[Callable] | None = None) -> None:
    """Seed ``random``, numpy and torch (the CPU and every CUDA device) with ``seed``
    modulo 2**32, and make cuDNN pick deterministic algorithms without benchmarking, as
    torch MONAI's ``set_determinism`` does. ``seed=None`` seeds torch from entropy and
    gives cuDNN back its defaults. ``additional_settings`` are called with the seed;
    ``use_deterministic_algorithms``, where given, goes to
    ``torch.use_deterministic_algorithms``."""
    global _seed
    if seed is None:
        torch.manual_seed(torch.default_generator.seed() % _MAX_SEED)
    else:
        seed = int(seed) % _MAX_SEED
        torch.manual_seed(seed)
    _seed = seed
    random.seed(seed)
    np.random.seed(seed)
    for func in () if additional_settings is None else ensure_tuple(additional_settings):
        func(seed)
    torch.backends.cudnn.deterministic = seed is not None
    torch.backends.cudnn.benchmark = False
    if use_deterministic_algorithms is not None:
        torch.use_deterministic_algorithms(use_deterministic_algorithms)


def get_seed() -> int | None:
    """The seed of the last ``set_determinism`` call (None before any, or after one with
    ``seed=None``)."""
    return _seed
