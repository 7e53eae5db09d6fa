"""The MedNIST bundle's transforms in monai_tpu_torch against monai_tpu's, on the CPU.

The JAX transforms run on ``jnp`` arrays (so a rotation is their ``ops/resample.py``, not
the C++ host path of numpy arrays).

- ``Rotate`` (2-D and 3-D, ``keep_size`` on and off) and ``RandRotate``/``RandRotated``
  with one seed: the same angles drawn and the same output within 1e-6 of max|ref| (the
  same float32 gather in the same tap order), the same affine (1e-9).
- ``Zoom`` at z < 1 and z > 1, eager (resample to floor(in z) at the border bound, then
  pad at the edge or crop) and lazy (one composed affine), one factor and one an axis,
  ``keep_size`` off, nearest; ``RandZoom``/``RandZoomd``: the same factors and outputs
  (1e-6 of max|ref|) and affines.
- ``ScaleIntensity``/``ScaleIntensityd``, minv/maxv, factor and channel-wise: within 1e-6.
- ``create_test_image_2d`` equal to the JAX package's for a seed, and
  ``make_synthetic_classification_datalist`` writing the same items and byte-identical
  files; the port's ``LoadImaged`` and ``EnsureChannelFirstd`` reading such a 2-D NIfTI as
  (1, 64, 64) float32 with the JAX package's values and affine.
- The bundle's training preprocessing as ``train.json`` lists it, in both packages with
  one seed, over its synthetic images: the same images (1e-6 of max|ref|) and affines.
"""
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monai_tpu.transforms as JT
import monai_tpu.utils as jax_utils
import monai_tpu_torch.transforms as TT
import monai_tpu_torch.utils as utils
from monai_tpu.apps.datasets import make_synthetic_classification_datalist as jax_datalist
from monai_tpu.data.meta_image import MetaImage as JaxMeta
from monai_tpu.data.synthetic import create_test_image_2d as jax_phantom
from monai_tpu_torch.apps.datasets import make_synthetic_classification_datalist
from monai_tpu_torch.data import MetaImage
from monai_tpu_torch.data.synthetic import create_test_image_2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_JSON = os.path.join(REPO, "bundles", "mednist_classification", "configs", "train.json")


def _image(shape, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _same(ref, got, tol: float = 1e-6) -> None:
    a, b = np.asarray(ref.data if hasattr(ref, "data") else ref), got.data.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30)
    if isinstance(got, MetaImage):
        np.testing.assert_allclose(got.affine, np.asarray(ref.affine), rtol=0, atol=1e-9)


def _pair(x: np.ndarray):
    return JaxMeta(jnp.asarray(x)), MetaImage(torch.from_numpy(x))


@pytest.mark.parametrize("shape,angle,keep", [((1, 64, 60), 0.2, True), ((1, 64, 60), -0.26, False),
                                              ((2, 20, 18, 16), (0.1, 0.2, -0.3), True)])
def test_rotate_matches_jax(shape, angle, keep):
    j, t = _pair(_image(shape))
    _same(JT.Rotate(angle, keep_size=keep)(j), TT.Rotate(angle, keep_size=keep)(t))


@pytest.mark.parametrize("zoom,lazy", [(0.9, False), (1.1, False), (0.93, True), (1.07, True),
                                       ((1.07, 0.91), False), ((0.95, 1.08), True)])
def test_zoom_matches_jax(zoom, lazy):
    j, t = _pair(_image((1, 64, 60), 1))
    ref, got = JT.Zoom(zoom, lazy=lazy)(j), TT.Zoom(zoom, lazy=lazy)(t)
    if lazy:
        from monai_tpu.transforms.lazy_executor import apply_pending as jax_apply_pending
        assert got.pending_operations and got.data.shape == (1, 64, 60)
        ref, got = jax_apply_pending(ref)[0], TT.apply_pending(got)[0]
    _same(ref, got)


@pytest.mark.parametrize("kwargs", [dict(keep_size=False), dict(mode="nearest"), dict(keep_size=False, mode="nearest"),
                                    dict(padding_mode="constant")])
def test_zoom_options_match_jax(kwargs):
    for zoom in (0.9, 1.1):
        j, t = _pair(_image((1, 31, 40), 2))
        _same(JT.Zoom(zoom, **kwargs)(j), TT.Zoom(zoom, **kwargs)(t))


@pytest.mark.parametrize("seed", [1, 2, 5, 11])
def test_rand_rotate_and_zoom_draw_as_jax(seed):
    x = _image((1, 64, 64), seed)
    pairs = [(JT.RandRotate(range_x=0.26, prob=0.5), TT.RandRotate(range_x=0.26, prob=0.5), "x"),
             (JT.RandZoom(prob=0.5, min_zoom=0.9, max_zoom=1.1), TT.RandZoom(prob=0.5, min_zoom=0.9, max_zoom=1.1),
              "_zoom"),
             (JT.RandRotated(keys="image", range_x=0.26, prob=0.5, keep_size=True),
              TT.RandRotated(keys="image", range_x=0.26, prob=0.5, keep_size=True), "x"),
             (JT.RandZoomd(keys="image", min_zoom=0.9, max_zoom=1.1, prob=0.5),
              TT.RandZoomd(keys="image", min_zoom=0.9, max_zoom=1.1, prob=0.5), "_zoom")]
    fired = 0
    for ref_t, t, attr in pairs:
        ref_t.set_random_state(seed)
        t.set_random_state(seed)
        inner_ref, inner = getattr(ref_t, "t", ref_t), getattr(t, "t", t)
        for _ in range(4):
            j, p = _pair(x)
            if hasattr(t, "keys"):
                ref, got = ref_t({"image": j})["image"], t({"image": p})["image"]
            else:
                ref, got = ref_t(j), t(p)
            assert inner._do_transform == inner_ref._do_transform
            assert np.all(np.asarray(getattr(inner, attr)) == np.asarray(getattr(inner_ref, attr)))
            fired += inner._do_transform
            _same(ref, got)
    assert fired > 0


@pytest.mark.parametrize("kwargs", [dict(), dict(minv=-1.0, maxv=2.0), dict(minv=None, maxv=3.0),
                                    dict(minv=None, maxv=None, factor=0.5), dict(channel_wise=True)])
def test_scale_intensity_matches_jax(kwargs):
    x = _image((2, 16, 12), 3) * 7 - 2
    x[1] *= 3
    j, t = _pair(x)
    _same(JT.ScaleIntensity(**kwargs)(j), TT.ScaleIntensity(**kwargs)(t))
    _same(JT.ScaleIntensityd(keys="image", **kwargs)({"image": j})["image"],
          TT.ScaleIntensityd(keys="image", **kwargs)({"image": t})["image"])


@pytest.mark.parametrize("kwargs", [dict(num_objs=3, rad_max=10, rad_min=4), dict(noise_max=0.2, num_seg_classes=3),
                                    dict(num_seg_classes=1, channel_dim=0), dict(channel_dim=-1)])
def test_create_test_image_2d_matches_jax(kwargs):
    kwargs = {"rad_max": 12, "rad_min": 3, **kwargs}
    ref = jax_phantom(64, 60, random_state=np.random.RandomState(7), **kwargs)
    got = create_test_image_2d(64, 60, random_state=np.random.RandomState(7), **kwargs)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_classification_datalist_writes_jax_files_and_reads_2d(tmp_path):
    ref = jax_datalist(str(tmp_path / "jax"), num_images=8, spatial_size=(64, 64), num_classes=6)
    got = make_synthetic_classification_datalist(str(tmp_path / "port"), num_images=8, spatial_size=(64, 64),
                                                 num_classes=6)
    for section in ("training", "validation"):
        assert [i["label"] for i in got[section]] == [i["label"] for i in ref[section]]
        for a, b in zip(ref[section], got[section]):
            assert os.path.basename(a["image"]) == os.path.basename(b["image"])
            assert gzip.open(a["image"]).read() == gzip.open(b["image"]).read()
    load = TT.Compose([TT.LoadImaged(keys="image", device="cpu"), TT.EnsureChannelFirstd(keys="image")])
    ref_load = JT.Compose([JT.LoadImaged(keys="image"), JT.EnsureChannelFirstd(keys="image")])
    for item, ref_item in zip(got["training"], ref["training"]):
        out, want = load(dict(item)), ref_load(dict(ref_item))
        assert out["image"].data.shape == (1, 64, 64) and out["image"].data.dtype == torch.float32
        _same(want["image"], out["image"], 0.0)
        assert out["label"] == item["label"]


def _bundle_pipeline(module, device_kw: dict, to_jnp: bool = False):
    cfg = json.load(open(TRAIN_JSON))["preprocessing"]["transforms"]
    steps = []
    for spec in cfg:
        kw = {k: v for k, v in spec.items() if k != "_target_"}
        steps.append(getattr(module, spec["_target_"])(**kw, **(device_kw if spec["_target_"] == "LoadImaged" else {})))
        if to_jnp and spec["_target_"] == "EnsureChannelFirstd":  # the JAX transforms on jnp arrays from here
            steps.append(lambda d: {**d, "image": d["image"].new_like(jnp.asarray(d["image"].data))})
    return module.Compose(steps)


@pytest.mark.parametrize("seed", [0, 3])
def test_bundle_preprocessing_matches_jax(tmp_path, seed):
    items = make_synthetic_classification_datalist(str(tmp_path), num_images=6, spatial_size=(64, 64),
                                                   num_classes=6)["training"]
    jax_utils.set_determinism(seed=seed)
    ref_pipe = _bundle_pipeline(JT, {}, to_jnp=True)
    utils.set_determinism(seed=seed)
    pipe = _bundle_pipeline(TT, {"device": "cpu"})
    assert [type(t).__name__ for t in pipe.transforms] == [s["_target_"] for s in
                                                          json.load(open(TRAIN_JSON))["preprocessing"]["transforms"]]
    for _ in range(2):
        for item in items:
            ref, out = ref_pipe(dict(item)), pipe(dict(item))
            assert isinstance(out["image"], MetaImage) and out["image"].data.shape == (1, 64, 64)
            _same(ref["image"], out["image"])
