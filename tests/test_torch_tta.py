"""The port's TestTimeAugmentation against the JAX package's pieces, on the CPU.

The JAX package's ``TestTimeAugmentation`` raises on every input: it wraps the batch of
predictions in one ``MetaImage``, which its ``decollate_batch`` does not split, so each
item's prediction is the whole batch and its inverse fails (held here, as a fault of the
reference). The port is held instead to what that class means, built from the JAX
package's own transforms: the same ``Compose([RandFlipd x2, RandRotated, RandZoomd])``
with one seed (and one global seed: each inverse flattens the Compose, which seeds its
transforms again, in both packages) over 6 copies of one 1x16x18x12 image, transformed a
batch of 2 at a time, an inferrer that makes two channels of the image (x and 1 - x^2),
each prediction inverted with ``Invertd`` at nearest interpolation, and scipy's mode,
numpy's mean and std and the volume variation coefficient of the stack. The mode, mean
and std agree within 1e-5 of max|ref|, the vvc within 1e-5 relative. At probability 0 the
mean is the plain forward bit for bit (and the std 0); with flips only, at probability 1,
every inverted prediction is the plain forward bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy import stats

import monai_tpu.transforms as JT
import monai_tpu.utils as jax_utils
from monai_tpu.data.meta_image import MetaImage as JaxMeta
from monai_tpu.data.test_time_augmentation import TestTimeAugmentation as JaxTTA
from monai_tpu.transforms.dictionary import Invertd as JInvertd
import monai_tpu_torch.transforms as TT
import monai_tpu_torch.utils as utils
from monai_tpu_torch.data import MetaImage
from monai_tpu_torch.data.test_time_augmentation import TestTimeAugmentation as TTA

AFFINE = np.diag([1.5, 1.5, 2.0, 1.0])


@pytest.fixture(autouse=True)
def determinism():
    utils.set_determinism(seed=0)
    jax_utils.set_determinism(seed=0)
    yield
    utils.set_determinism(seed=None)
    jax_utils.set_determinism(seed=None)


def _transform(m, prob=0.6, flips_only=False):
    ts = [m.RandFlipd("image", prob=prob, spatial_axis=0), m.RandFlipd("image", prob=prob, spatial_axis=2)]
    if not flips_only:
        ts += [m.RandRotated("image", range_x=0.3, prob=prob), m.RandZoomd("image", prob=prob, min_zoom=0.85,
                                                                            max_zoom=1.15)]
    return m.Compose(ts).set_random_state(seed=3)


def _port_infer(x):
    return torch.cat([x, 1 - x * x], dim=1)


def _jax_infer(x):
    return jnp.concatenate([x, 1 - x * x], axis=1)


def _image():
    return np.random.RandomState(1).rand(1, 16, 18, 12).astype(np.float32)


def _reference(x, num, batch_size):
    """The JAX package's transforms and Invertd, batch by batch as the TTA runs them."""
    transform = _transform(JT)
    inverter = JInvertd("pred", transform, orig_keys="image", nearest_interp=True)
    outs = []
    for start in range(0, num, batch_size):
        items = [transform({"image": JaxMeta(jnp.asarray(x), affine=AFFINE)})
                 for _ in range(min(batch_size, num - start))]
        for item in items:
            item["pred"] = JaxMeta(_jax_infer(item["image"].data[None])[0])
            outs.append(np.asarray(inverter(item)["pred"].data))
    full = np.stack(outs)
    return stats.mode(full, axis=0, keepdims=False).mode, full.mean(0), full.std(0), full.std() / (full.mean() + 1e-12)


def test_jax_tta_fails_on_its_batch():
    ref = JaxTTA(_transform(JT), batch_size=2, inferrer_fn=_jax_infer)
    with pytest.raises(RuntimeError, match="applying transform"):
        ref({"image": JaxMeta(jnp.asarray(_image()), affine=AFFINE)}, num_examples=2)


def test_tta_matches_jax_pieces():
    x = _image()
    tta = TTA(_transform(TT), batch_size=2, inferrer_fn=_port_infer)
    mode, mean, std, vvc = tta({"image": MetaImage(torch.from_numpy(x), AFFINE)}, num_examples=6)
    jmode, jmean, jstd, jvvc = _reference(x, 6, 2)
    for got, want in ((mode, jmode), (mean, jmean), (std, jstd)):
        assert tuple(got.shape) == want.shape == (2, 16, 18, 12)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(vvc - jvvc) <= 1e-5 * abs(jvvc)
    assert std.max() > 0  # the draws moved the predictions


def test_tta_at_probability_zero_is_the_plain_forward():
    x = torch.from_numpy(_image())
    tta = TTA(_transform(TT, prob=0.0), batch_size=2, inferrer_fn=_port_infer)
    _, mean, std, _ = tta({"image": MetaImage(x, AFFINE)}, num_examples=4)
    assert torch.equal(mean, _port_infer(x[None])[0]) and torch.equal(std, torch.zeros_like(std))


def test_tta_flip_inverses_restore_the_grid_exactly():
    x = torch.from_numpy(_image())
    tta = TTA(_transform(TT, prob=1.0, flips_only=True), batch_size=2, inferrer_fn=_port_infer,
                               return_full_data=True)
    full = tta({"image": MetaImage(x, AFFINE)}, num_examples=4)
    want = _port_infer(x[None])[0]
    assert all(torch.equal(p, want) for p in full)
