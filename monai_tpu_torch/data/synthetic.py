"""Synthetic phantoms (counterpart of monai_tpu/data/synthetic.py's
``create_test_image_3d``): blobby spheres and their segmentation, drawn with numpy from a
``RandomState``. The same arithmetic and the same draws in the same order as the JAX
package, so one seed gives the same phantoms, byte for byte."""
from __future__ import annotations

import numpy as np

__all__ = ["create_test_image_3d"]


def create_test_image_3d(height: int, width: int, depth: int, num_objs: int = 12, rad_max: int = 30,
                         rad_min: int = 5, noise_max: float = 0.0, num_seg_classes: int = 5,
                         channel_dim: int | None = None, random_state: np.random.RandomState | None = None):
    """A (height, width, depth) float32 image of ``num_objs`` spheres, each filled with a
    class in 1..``num_seg_classes`` (divided by it in the image), and its int32 labels;
    with ``channel_dim`` 0 or -1 (3) a channel axis there."""
    if rad_max <= rad_min:
        raise ValueError(f"rad_min {rad_min} should be less than rad_max {rad_max}.")
    if rad_min < 1:
        raise ValueError("rad_min should be no less than 1.")
    if min(height, width, depth) <= 2 * rad_max:
        raise ValueError("the minimal size of the image should be larger than `2 * rad_max`.")
    image = np.zeros((height, width, depth))
    rs: np.random.RandomState = np.random.random.__self__ if random_state is None else random_state  # type: ignore
    for _ in range(num_objs):
        x = rs.randint(rad_max, height - rad_max)
        y = rs.randint(rad_max, width - rad_max)
        z = rs.randint(rad_max, depth - rad_max)
        rad = rs.randint(rad_min, rad_max)
        spy, spx, spz = np.ogrid[-x:height - x, -y:width - y, -z:depth - z]
        sphere = (spx * spx + spy * spy + spz * spz) <= rad * rad
        image[sphere] = np.ceil(rs.random() * num_seg_classes) if num_seg_classes > 1 else rs.random() * 0.5 + 0.5
    labels = np.ceil(image).astype(np.int32)
    norm = rs.uniform(0, num_seg_classes * noise_max, size=image.shape)
    if noise_max > 0:
        noisyimage = np.clip((image / max(num_seg_classes, 1)) + norm, 0, 1).astype(np.float32)
    else:
        noisyimage = (image / max(num_seg_classes, 1)).astype(np.float32)
    if channel_dim is None:
        return noisyimage, labels
    if not (isinstance(channel_dim, int) and channel_dim in (-1, 0, 3)):
        raise AssertionError("invalid channel dim.")
    if channel_dim == 0:
        return noisyimage[None], labels[None]
    return noisyimage[..., None], labels[..., None]
