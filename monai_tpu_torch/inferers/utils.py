"""sliding_window_inference (counterpart of monai_tpu/inferers/utils.py).

An eager loop over window batches of ``sw_batch_size``: gather the windows by slicing,
run the predictor, weight each prediction by the importance map and add it into a
float32 accumulator, add the map into a count map, and divide at the end. The JAX
package's compiled-scan machinery (jit and constant caches, the predictor-shape memo,
the TPU placement-einsum stitch) has no counterpart: PyTorch runs eagerly.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch
import torch.nn.functional as F

from ..data.utils import compute_importance_map, dense_patch_slices, get_valid_patch_size
from ..utils.backend import to_torch
from ..utils.enums import BlendMode
from ..utils.misc import ensure_tuple_rep, fall_back_tuple

__all__ = ["compute_scan_interval", "sliding_window_inference"]

_PAD_MODES = {"constant": "constant", "zeros": "constant", "reflect": "reflect", "reflection": "reflect",
              "replicate": "replicate", "edge": "replicate", "circular": "circular"}


def compute_scan_interval(image_size: Sequence[int], roi_size: Sequence[int], num_spatial_dims: int,
                          overlap: Sequence[float]) -> tuple:
    """Scan interval per dim: ``roi * (1 - overlap)``, at least 1; the roi itself where it
    spans the whole dim."""
    scan_interval = []
    for i, o in zip(range(num_spatial_dims), overlap):
        if roi_size[i] == image_size[i]:
            scan_interval.append(int(roi_size[i]))
        else:
            interval = int(roi_size[i] * (1 - o))
            scan_interval.append(interval if interval > 0 else 1)
    return tuple(scan_interval)


def sliding_window_inference(inputs: Any, roi_size: Sequence[int] | int, sw_batch_size: int,
                             predictor: Callable[..., torch.Tensor], overlap: Sequence[float] | float = 0.25,
                             mode: str = BlendMode.CONSTANT, sigma_scale: Sequence[float] | float = 0.125,
                             padding_mode: str = "constant", cval: float = 0.0, *args,
                             device: torch.device | str | None = None, **kwargs) -> torch.Tensor:
    """Run ``predictor`` over sliding windows of ``inputs`` (B, C, *spatial) and blend the
    window predictions into a float32 output (B, C_out, *spatial).

    ``predictor(windows, *args, **kwargs)`` takes (sw_batch_size * B, C, *roi) and must
    return (sw_batch_size * B, C_out, *roi). Inputs smaller than the roi are padded
    symmetrically with ``padding_mode`` (``cval`` for constant) and cropped back. The
    output is stitched on ``device`` (default: the input's), e.g. on the host when the
    card's memory does not hold it."""
    x = to_torch(inputs)
    num_spatial_dims = x.ndim - 2
    batch_size = x.shape[0]
    image_size_ = tuple(x.shape[2:])
    overlap_ = ensure_tuple_rep(overlap, num_spatial_dims)
    if any(o < 0 or o >= 1 for o in overlap_):
        raise ValueError(f"overlap must be >= 0 and < 1, got {overlap}.")
    if sw_batch_size < 1:
        raise ValueError(f"sw_batch_size must be >= 1, got {sw_batch_size}.")
    roi_size_ = fall_back_tuple(roi_size, image_size_)

    # pad symmetrically where the roi is larger than the image
    image_size = tuple(max(i, r) for i, r in zip(image_size_, roi_size_))
    pad_lo = [(r - i) // 2 if r > i else 0 for i, r in zip(image_size_, roi_size_)]
    if image_size != image_size_:
        pad = []
        for k in reversed(range(num_spatial_dims)):  # F.pad lists the last dim first
            diff = image_size[k] - image_size_[k]
            pad += [pad_lo[k], diff - pad_lo[k]]
        torch_mode = _PAD_MODES.get(str(padding_mode), "constant")
        x = F.pad(x, pad, mode=torch_mode, value=cval) if torch_mode == "constant" else F.pad(x, pad, mode=torch_mode)

    scan_interval = compute_scan_interval(image_size, roi_size_, num_spatial_dims, overlap_)
    slices = dense_patch_slices(image_size, roi_size_, scan_interval)
    device = x.device if device is None else torch.device(device)
    importance = compute_importance_map(get_valid_patch_size(image_size, roi_size_), mode=mode,
                                        sigma_scale=sigma_scale, device=device)

    out = count = None
    for c0 in range(0, len(slices), sw_batch_size):
        chunk = slices[c0:c0 + sw_batch_size]
        windows = torch.cat([x[(slice(None), slice(None)) + sl] for sl in chunk])
        preds = predictor(windows, *args, **kwargs).to(device)
        if tuple(preds.shape[2:]) != tuple(roi_size_) or preds.shape[0] != windows.shape[0]:
            raise ValueError(f"predictor must map windows {tuple(windows.shape)} to (N, C_out, *roi); "
                             f"got {tuple(preds.shape)}")
        if out is None:
            out = torch.zeros((batch_size, preds.shape[1]) + image_size, dtype=torch.float32, device=device)
            count = torch.zeros((1, 1) + image_size, dtype=torch.float32, device=device)
        for i, sl in enumerate(chunk):
            idx = (slice(None), slice(None)) + sl
            out[idx].add_(preds[i * batch_size:(i + 1) * batch_size] * importance)
            count[idx].add_(importance)
    out = out / count

    if image_size != image_size_:
        crop = (slice(None), slice(None)) + tuple(slice(lo, lo + s) for lo, s in zip(pad_lo, image_size_))
        out = out[crop]
    return out
