"""Launch counters that threads share (no counterpart in monai_tpu, whose kernels run
under jit). Each kernel wrapper keeps its count as an attribute of itself
(``conv3d_3x3_same.launches``), and ``count_launch`` adds to it under one lock: the
DataLoader's worker threads launch the resample beside the main thread's launches, and a
bare ``+=`` on an attribute can lose a count when two threads interleave."""
from __future__ import annotations

import threading

__all__ = ["count_launch"]

_LOCK = threading.Lock()


def count_launch(wrapper, n: int = 1, name: str = "launches") -> None:
    """Add ``n`` to ``wrapper.<name>``, atomically with respect to other threads."""
    with _LOCK:
        setattr(wrapper, name, getattr(wrapper, name) + n)
