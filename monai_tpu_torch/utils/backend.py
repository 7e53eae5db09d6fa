"""numpy ⇄ torch conversion, device and dtype helpers (counterpart of
monai_tpu/utils/backend.py, which does the same between numpy and jax.numpy), and the
float32 precision of the port's cuDNN calls."""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Iterator
from typing import Any

import numpy as np
import torch

__all__ = ["full_float32", "get_torch_dtype", "resolve_device", "to_numpy", "to_torch"]

_NAMED_DTYPES = {"float32": torch.float32, "float": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "half": torch.float16, "float64": torch.float64}


def get_torch_dtype(dtype: Any) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or a name such as ``"bfloat16"``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _NAMED_DTYPES:
        return _NAMED_DTYPES[dtype]
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


def resolve_device(device: Any = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and raises where
    there is none: the port's entry points run on the card unless the caller asks for
    the CPU (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: monai_tpu_torch runs on the card by default; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def to_torch(x: Any, device: Any = None, dtype: Any = None) -> torch.Tensor:
    """Convert an array-like to a tensor, moving it only where ``device`` or ``dtype`` ask."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=None if device is None else resolve_device(device),
                dtype=None if dtype is None else get_torch_dtype(dtype))


def to_numpy(x: Any, dtype: Any = None) -> np.ndarray:
    """Convert a tensor (any device) or array-like to a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16
            x = x.float()
        x = x.cpu().numpy()
    out = np.asarray(x)
    return out if dtype is None else out.astype(dtype, copy=False)


_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def full_float32(x: torch.Tensor) -> Iterator[None]:
    """Around a cuDNN call on ``x``: where ``x`` is a float32 CUDA tensor, TF32 is off
    (``torch.backends.cudnn.allow_tf32``) for the call and the caller's setting comes
    back after. The setting is global, so threads that run such calls at once take
    turns; a float32 convolution's backward runs later, under the caller's setting."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        yield
        return
    with _TF32_LOCK:
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = before
