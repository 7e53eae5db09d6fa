"""The BraTS bundle's transforms in monai_tpu_torch against monai_tpu's, on the CPU.

Seeded with numpy; the random ones get the same seed in both packages and must draw the
same: ``RandSpatialCrop(d)`` the same box (so the same voxels, exactly), and
``RandScaleIntensity(d)`` the same factor (float32 products, within 1e-6 of max|ref|).
``ConvertToMultiChannelBasedOnBratsClasses(d)``, ``Activations(sigmoid)`` and
``AsDiscrete(threshold)`` are exact. ``NormalizeIntensity(d)`` (``nonzero``,
``channel_wise``): the port sums its statistics in float64, the JAX package in float32,
so within 1e-5 of max|ref|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monai_tpu.transforms as jax_transforms
import monai_tpu_torch.transforms as transforms
from monai_tpu.data.meta_image import MetaImage as JaxMetaImage
from monai_tpu_torch.data import MetaImage


def _pair(x: np.ndarray):
    """The same array as a JAX MetaImage and as the port's."""
    affine = np.diag([1.5, 1.0, 2.0, 1.0])
    return JaxMetaImage(jnp.asarray(x), affine=affine), MetaImage(torch.from_numpy(x.copy()), affine=affine)


def _labels(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).choice([0, 1, 2, 3, 4], size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 6, 7, 8), (6, 7, 8)])
def test_convert_brats_classes_matches_jax(shape):
    x = _labels(shape)
    ref = np.asarray(jax_transforms.ConvertToMultiChannelBasedOnBratsClasses()(jnp.asarray(x)))
    got = transforms.ConvertToMultiChannelBasedOnBratsClasses()(torch.from_numpy(x))
    assert got.shape == ref.shape == (3, 6, 7, 8) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    # the tumour core 1, 3, 4; the whole tumour 1-4; the enhancing tumour 3, 4
    assert np.array_equal(got.numpy()[1], (x.reshape(6, 7, 8) > 0).astype(np.float32))
    # numpy in, float32 numpy out, as the JAX package gives
    assert np.array_equal(transforms.ConvertToMultiChannelBasedOnBratsClasses()(x), ref)


def test_convert_brats_classes_dict_keeps_the_meta():
    ref_img, img = _pair(_labels((1, 5, 6, 7), seed=1))
    ref = jax_transforms.ConvertToMultiChannelBasedOnBratsClassesd(keys="label")({"label": ref_img})["label"]
    got = transforms.ConvertToMultiChannelBasedOnBratsClassesd(keys="label")({"label": img})["label"]
    assert isinstance(got, MetaImage) and np.array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.affine, np.asarray(ref.affine))


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("kwargs", [dict(roi_size=(5, 6, 7)), dict(roi_size=(5, -1, 7)),
                                    dict(roi_size=(4, 4, 4), random_size=True, max_roi_size=(9, 10, 8)),
                                    dict(roi_size=(5, 6, 7), random_center=False)])
def test_rand_spatial_crop_draws_as_jax(seed, kwargs):
    x = np.random.RandomState(seed).rand(2, 12, 13, 14).astype(np.float32)
    ref_img, img = _pair(x)
    ref_t, t = jax_transforms.RandSpatialCrop(**kwargs), transforms.RandSpatialCrop(**kwargs)
    ref_t.set_random_state(seed)
    t.set_random_state(seed)
    for _ in range(3):
        ref, got = ref_t(ref_img), t(img)
        assert got.data.shape == np.asarray(ref.data).shape
        assert np.array_equal(got.data.numpy(), np.asarray(ref.data))
        np.testing.assert_allclose(got.affine, np.asarray(ref.affine), atol=1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_rand_spatial_crop_dict_crops_every_key_alike(seed):
    x = np.random.RandomState(seed).rand(1, 20, 18, 16).astype(np.float32)
    y = _labels((3, 20, 18, 16), seed)
    (ref_x, port_x), (ref_y, port_y) = _pair(x), _pair(y)
    kw = dict(keys=["image", "label"], roi_size=(8, 8, 8), random_size=False)
    ref_t, t = jax_transforms.RandSpatialCropd(**kw), transforms.RandSpatialCropd(**kw)
    ref_t.set_random_state(seed)
    t.set_random_state(seed)
    for _ in range(3):
        ref, got = ref_t({"image": ref_x, "label": ref_y}), t({"image": port_x, "label": port_y})
        for key in ("image", "label"):
            assert got[key].data.shape[1:] == (8, 8, 8)
            assert np.array_equal(got[key].data.numpy(), np.asarray(ref[key].data)), key
        np.testing.assert_allclose(got["image"].affine, got["label"].affine)


@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("channel_wise", [False, True])
def test_normalize_intensity_matches_jax(nonzero, channel_wise):
    rng = np.random.RandomState(int(nonzero) * 2 + int(channel_wise))
    x = (rng.rand(3, 10, 11, 12) * np.array([1.0, 50.0, 300.0])[:, None, None, None] + 20).astype(np.float32)
    x[rng.rand(*x.shape) < 0.4] = 0.0  # a brain MRI's zero background
    x[2, :5] = 0.0
    ref_img, img = _pair(x)
    kw = dict(nonzero=nonzero, channel_wise=channel_wise)
    ref = np.asarray(jax_transforms.NormalizeIntensity(**kw)(ref_img).data)
    got = transforms.NormalizeIntensity(**kw)(img)
    assert isinstance(got, MetaImage) and got.data.dtype == torch.float32
    assert np.abs(got.data.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    if nonzero:
        assert np.array_equal(got.data.numpy() == 0, x == 0)  # the zeros stay where they were


@pytest.mark.parametrize("kw", [dict(subtrahend=2.0, divisor=4.0), dict(nonzero=True, subtrahend=1.0),
                                dict(channel_wise=True, subtrahend=[1.0, 2.0], divisor=[2.0, 0.0])])
def test_normalize_intensity_given_statistics(kw):
    x = np.random.RandomState(7).rand(2, 4, 5, 6).astype(np.float32)
    x[0, 0] = 0.0
    ref = np.asarray(jax_transforms.NormalizeIntensity(**kw)(jnp.asarray(x)))
    got = transforms.NormalizeIntensity(**kw)(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_normalize_intensity_dict_matches_jax():
    x = np.random.RandomState(4).rand(4, 6, 7, 8).astype(np.float32) * 100
    x[:, :2] = 0.0
    ref_img, img = _pair(x)
    kw = dict(keys="image", nonzero=True, channel_wise=True)
    ref = np.asarray(jax_transforms.NormalizeIntensityd(**kw)({"image": ref_img})["image"].data)
    got = transforms.NormalizeIntensityd(**kw)({"image": img})["image"].data.numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("seed", [0, 2, 9])
@pytest.mark.parametrize("kwargs", [dict(factors=0.1, prob=1.0), dict(factors=(-0.3, 0.5), prob=0.5),
                                    dict(factors=0.2, prob=1.0, channel_wise=True)])
def test_rand_scale_intensity_draws_as_jax(seed, kwargs):
    x = np.random.RandomState(seed).randn(3, 6, 7, 8).astype(np.float32)
    ref_img, img = _pair(x)
    ref_t, t = jax_transforms.RandScaleIntensity(**kwargs), transforms.RandScaleIntensity(**kwargs)
    ref_t.set_random_state(seed)
    t.set_random_state(seed)
    for _ in range(4):
        ref, got = ref_t(ref_img), t(img)
        ref = np.asarray(ref.data)
        assert np.abs(got.data.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        assert t._do_transform == ref_t._do_transform and np.allclose(t.factor, ref_t.factor, rtol=0, atol=0)


def test_rand_scale_intensity_dict_draws_as_jax():
    x = np.random.RandomState(5).rand(1, 6, 7, 8).astype(np.float32)
    ref_img, img = _pair(x)
    kw = dict(keys="image", factors=0.1, prob=1.0)
    ref_t, t = jax_transforms.RandScaleIntensityd(**kw), transforms.RandScaleIntensityd(**kw)
    ref_t.set_random_state(13)
    t.set_random_state(13)
    for _ in range(3):
        ref = np.asarray(ref_t({"image": ref_img})["image"].data)
        got = t({"image": img})["image"].data.numpy()
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max() and not np.array_equal(got, x)


def test_sigmoid_and_threshold_post_transforms_match_jax():
    logits = np.random.RandomState(6).randn(3, 5, 6, 7).astype(np.float32) * 3
    ref_img, img = _pair(logits)
    ref = jax_transforms.Compose([jax_transforms.Activationsd(keys="pred", sigmoid=True),
                                  jax_transforms.AsDiscreted(keys="pred", threshold=0.5)])({"pred": ref_img})["pred"]
    got = transforms.Compose([transforms.Activationsd(keys="pred", sigmoid=True),
                              transforms.AsDiscreted(keys="pred", threshold=0.5)])({"pred": img})["pred"]
    assert got.data.dtype == torch.float32 and np.array_equal(got.data.numpy(), np.asarray(ref.data))
    assert np.array_equal(got.data.numpy(), (logits >= 0).astype(np.float32))
    probs = transforms.Activations(sigmoid=True)(torch.from_numpy(logits))
    ref_probs = np.asarray(jax_transforms.Activations(sigmoid=True)(jnp.asarray(logits)))
    assert np.abs(probs.numpy() - ref_probs).max() <= 1e-6
    assert torch.equal(transforms.AsDiscrete()(probs, threshold=0.25), (probs >= 0.25).float())
    with pytest.raises(ValueError, match="sigmoid=True and softmax=True"):
        transforms.Activations()(probs, sigmoid=True, softmax=True)
