"""Test-time augmentation (counterpart of monai_tpu/data/test_time_augmentation.py):
``TestTimeAugmentation`` runs a random, invertible transform over copies of one input,
infers each, inverts each prediction back onto the input's grid (``Invertd``) and
returns the mode, mean, standard deviation and volume variation coefficient of the
predictions. The forwards and the inverses run where the data lie (the card, for the
port's ``LoadImaged`` output)."""
from __future__ import annotations

import warnings
from collections.abc import Callable
from typing import Any

import torch

from ..transforms.compose import Compose
from ..transforms.dictionary import Invertd
from ..transforms.transform import Randomizable
from ..utils.enums import CommonKeys
from .dataloader import DataLoader
from .dataset import Dataset
from .meta_image import MetaImage
from .utils import decollate_batch

__all__ = ["TestTimeAugmentation"]


def _identity(x):
    return x


def _mode(full: torch.Tensor) -> torch.Tensor:
    """The most frequent value along axis 0, the smallest of them on a tie (scipy's
    ``stats.mode``), as counts of equal values over the sorted samples."""
    ordered = full.sort(dim=0).values
    counts = (ordered[:, None] == ordered[None]).sum(dim=1)
    return ordered.gather(0, counts.argmax(dim=0, keepdim=True))[0]


class TestTimeAugmentation:
    """Run ``transform`` (a dict transform with at least one random, invertible part) on
    ``num_examples`` copies of ``data``, ``inferrer_fn`` on each batch of ``batch_size``
    of their ``image_key`` images (moved to ``device`` where it is given), invert each
    prediction with ``transform``'s inverse (``Invertd``, at nearest interpolation with
    ``nearest_interp``), and return ``(mode, mean, std, vvc)`` over the examples: the
    voxelwise mode, mean and standard deviation (divided by n), and the whole stack's
    standard deviation over its mean. ``return_full_data`` returns the stacked
    predictions instead. The other arguments are taken for the JAX package's signature."""

    def __init__(self, transform, batch_size: int, num_workers: int = 0, inferrer_fn: Callable = _identity,
                 device=None, image_key=CommonKeys.IMAGE, orig_key=CommonKeys.LABEL, nearest_interp: bool = True,
                 orig_meta_keys=None, meta_key_postfix="meta_dict", to_tensor: bool = True, output_device=None,
                 post_func: Callable = _identity, return_full_data: bool = False, progress: bool = False):
        self.transform = transform
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.inferrer_fn = inferrer_fn
        self.device = device
        self.image_key = image_key
        self.orig_key = orig_key
        self.nearest_interp = nearest_interp
        self.return_full_data = return_full_data
        self.progress = progress
        ts = self.transform.transforms if isinstance(self.transform, Compose) else [self.transform]
        if not any(isinstance(t, Randomizable) for t in ts):
            warnings.warn("TTA usually has at least one random transform in the pipeline.")

    def __call__(self, data: dict[str, Any], num_examples: int = 10):
        if num_examples < 1:
            raise ValueError("num_examples should be multiple of batch size.")
        loader = DataLoader(Dataset([dict(data) for _ in range(num_examples)], self.transform),
                            batch_size=self.batch_size, num_workers=self.num_workers)
        inverter = Invertd(keys=CommonKeys.PRED, transform=self.transform, orig_keys=self.image_key,
                           nearest_interp=self.nearest_interp)
        outs = []
        for batch in loader:
            images = batch[self.image_key]
            x = images.data if isinstance(images, MetaImage) else images
            batch[CommonKeys.PRED] = self.inferrer_fn(x if self.device is None else x.to(self.device))
            for item in decollate_batch(batch):
                pred = inverter(item)[CommonKeys.PRED]
                outs.append(pred.data if isinstance(pred, MetaImage) else pred)
        full = torch.stack(outs)
        if self.return_full_data:
            return full
        vvc = float(full.std(correction=0) / (full.mean() + 1e-12))
        return _mode(full), full.mean(0), full.std(0, correction=0), vvc
