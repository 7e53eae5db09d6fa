"""monai_tpu_torch — the PyTorch/CUDA port of monai_tpu.

Mirrors ``monai_tpu``'s module paths and names. Plain tensor code is PyTorch; the
TPU kernels of ``monai_tpu`` become hand-written Hopper kernels (CUDA C++ under
``csrc/``). Imports ``torch`` and never ``jax``.
"""
from __future__ import annotations

import importlib
import sys

__version__ = "0.1.0"

__all__ = ["bundle", "data", "engines", "handlers", "inferers", "losses", "metrics", "networks", "ops", "transforms",
           "utils"]

_SUBMODULES = set(__all__)


def __getattr__(name: str):
    """Lazy subpackage import — keeps `import monai_tpu_torch` cheap."""
    if name in _SUBMODULES:
        mod = importlib.import_module(f"{__name__}.{name}")
        setattr(sys.modules[__name__], name, mod)
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _SUBMODULES)
