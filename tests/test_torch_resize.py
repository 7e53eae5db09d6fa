"""``Resize``, ``Resized`` and Auto3DSeg's ``EnsureSameShaped`` in monai_tpu_torch against
monai_tpu's, on the CPU.

- ``Resize`` on a 2-channel 11x9x7 image with an anisotropic affine, growing and
  shrinking axes: nearest bit for bit (the JAX rule, index floor(y * in / out)),
  trilinear and anti-aliased (the port's Gaussian filter) within 1e-5 of max|ref|, at
  ``size_mode`` "all" (with a -1 axis) and "longest", with and without
  ``align_corners``; the output affine and the inverse (shape, values within the same
  tolerance, affine) equal the JAX package's. ``Resized`` over two keys with a mode each.
- ``EnsureSameShaped``: a label 3 voxels short on one axis comes back resized to the
  image's shape bit for bit as the JAX package's, with the same warning; a label past
  ``allowed_shape_difference`` raises the same error; equal shapes pass untouched.
"""
import warnings

import numpy as np
import pytest
import torch

import monai_tpu.apps.auto3dseg as jax_a3d
import monai_tpu.transforms as jax_transforms
from monai_tpu.data.meta_image import MetaImage as JaxMetaImage
import monai_tpu_torch.transforms as transforms
from monai_tpu_torch.apps import auto3dseg as a3d
from monai_tpu_torch.data.meta_image import MetaImage

AFFINE = np.diag([1.5, 2.0, 0.7, 1.0])
CASES = {
    "nearest": dict(spatial_size=(8, 12, 7), mode="nearest"),
    "nearest_corners": dict(spatial_size=(5, 13, 9), mode="nearest", align_corners=True),
    "trilinear": dict(spatial_size=(8, 12, 7), mode="trilinear"),
    "trilinear_corners": dict(spatial_size=(8, 12, 10), mode="bilinear", align_corners=True),
    "keep_axis": dict(spatial_size=(6, -1, 4), mode="bilinear"),
    "anti_aliased": dict(spatial_size=(6, 5, 4), mode="bilinear", anti_aliasing=True),
    "anti_aliased_sigma": dict(spatial_size=(6, 12, 4), mode="trilinear", anti_aliasing=True,
                               anti_aliasing_sigma=(0.8, 0.5, 1.2)),
    "longest": dict(spatial_size=7, size_mode="longest", mode="trilinear"),
    "longest_nearest": dict(spatial_size=15, size_mode="longest", mode="nearest"),
}


def _image(seed=0):
    return np.random.RandomState(seed).rand(2, 11, 9, 7).astype(np.float32)


def _check(got, ref, exact):
    a, b = np.asarray(ref.data), got.data.numpy()
    assert a.shape == b.shape and b.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(b, a)
    else:
        assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max()
    np.testing.assert_allclose(np.asarray(got.affine), np.asarray(ref.affine), rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resize_and_its_inverse_match_jax(case):
    kw = CASES[case]
    x = _image()
    ref_t, t = jax_transforms.Resize(**kw), transforms.Resize(**kw)
    ref = ref_t(JaxMetaImage(x, affine=AFFINE))
    got = t(MetaImage(torch.from_numpy(x), affine=AFFINE))
    exact = kw["mode"] == "nearest"
    _check(got, ref, exact)
    _check(t.inverse(got), ref_t.inverse(ref), exact)


def test_resized_matches_jax():
    x = _image(1)
    label = (x[:1] > 0.5).astype(np.float32)
    kw = dict(keys=["image", "label"], spatial_size=(9, 6, 8), mode=["trilinear", "nearest"])
    ref = jax_transforms.Resized(**kw)({"image": JaxMetaImage(x, affine=AFFINE),
                                       "label": JaxMetaImage(label, affine=AFFINE)})
    got = transforms.Resized(**kw)({"image": MetaImage(torch.from_numpy(x), affine=AFFINE),
                                    "label": MetaImage(torch.from_numpy(label), affine=AFFINE)})
    _check(got["image"], ref["image"], exact=False)
    _check(got["label"], ref["label"], exact=True)


def _pair(label_shape, meta=True):
    rs = np.random.RandomState(2)
    image = rs.rand(1, 14, 12, 10).astype(np.float32)
    label = rs.randint(0, 3, (1, *label_shape)).astype(np.float32)
    m = {"filename_or_obj": "seg_07.nii.gz"} if meta else None
    return ({"image": JaxMetaImage(image, affine=AFFINE), "label": JaxMetaImage(label, affine=AFFINE, meta=m)},
            {"image": MetaImage(torch.from_numpy(image), affine=AFFINE),
             "label": MetaImage(torch.from_numpy(label), affine=AFFINE, meta=m)})


def _warned(fn, data):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(data)
    return out, [str(w.message) for w in caught if "resized" in str(w.message)]


@pytest.mark.parametrize("label_shape", [(14, 9, 10), (12, 12, 13)])
def test_ensure_same_shaped_matches_jax(label_shape):
    ref_d, d = _pair(label_shape)
    ref, ref_msgs = _warned(jax_a3d.EnsureSameShaped(), ref_d)
    got, msgs = _warned(a3d.EnsureSameShaped(), d)
    assert tuple(got["label"].shape) == (1, 14, 12, 10)
    np.testing.assert_array_equal(got["label"].data.numpy(), np.asarray(ref["label"].data))
    assert msgs == ref_msgs and len(msgs) == 1 and "seg_07.nii.gz" in msgs[0]
    assert got["image"] is d["image"]


def test_ensure_same_shaped_refuses_and_passes_as_jax():
    ref_d, d = _pair((14, 12, 4))
    with pytest.raises(ValueError) as ref_err:
        jax_a3d.EnsureSameShaped(allowed_shape_difference=5)(ref_d)
    with pytest.raises(ValueError) as err:
        a3d.EnsureSameShaped(allowed_shape_difference=5)(d)
    assert str(err.value) == str(ref_err.value)
    _, d = _pair((14, 12, 10))
    out, msgs = _warned(a3d.EnsureSameShaped(), d)
    assert out["label"] is d["label"] and msgs == []
