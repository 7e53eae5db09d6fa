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


# The kernels' torch operators (``torch.ops.monai_tpu_torch.conv3d_3x3_same``,
# ``instance_norm_prelu`` and ``fused_window_attention``), which a ``torch.export`` program of
# the port's networks calls (``bundle.ckpt_export``): importing the package registers them.
from .networks.layers import fast_norm as _fast_norm  # noqa: E402,F401
from .ops import conv3d as _conv3d, window_attention as _window_attention  # noqa: E402,F401


def __getattr__(name: str):
    """Lazy import of the subpackages (the operators' modules above are imported at once)."""
    if name in _SUBMODULES:
        mod = importlib.import_module(f"{__name__}.{name}")
        setattr(sys.modules[__name__], name, mod)
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _SUBMODULES)
