"""``from_engine`` (counterpart of monai_tpu/handlers/ignite_metric.py ``from_engine``):
pick keys out of an engine's output or batch."""
from __future__ import annotations

from ..utils.misc import ensure_tuple

__all__ = ["from_engine"]


def from_engine(keys, first: bool = False):
    """A function that takes an engine's output (a dict, or a list of dicts where it was
    decollated) and returns the values under ``keys``: a tuple for a dict; for a list,
    each key's values over the items (only the first item's with ``first``), a tuple of
    them where there are several keys."""
    keys = ensure_tuple(keys)

    def _wrapper(data):
        if isinstance(data, dict):
            return tuple(data[k] for k in keys)
        if isinstance(data, list) and isinstance(data[0], dict):
            ret = [data[0][k] if first else [item[k] for item in data] for k in keys]
            return tuple(ret) if len(ret) > 1 else ret[0]
        return data

    return _wrapper
