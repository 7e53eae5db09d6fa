"""The inverses of the port's random spatial transforms and containers, its
SpatialResample and resampling on write, against the JAX package's, on the CPU.

The JAX transforms run on ``jnp`` arrays (their ``ops/resample.py``), both packages with
the same seeds, so the same draws. Held here, on a 2-channel 12x14x10 image:

- ``RandFlip``, ``RandRotate90``, ``RandRotate`` and ``RandZoom`` at probability 0.5 over 6 calls: the same
  draws (the skipped calls the same, each recording ``{"skipped": True}``), the same
  outputs and their inverses; flips and quarter turns exactly, rotations and zooms within
  1e-5 of max|ref|. A flip's or a quarter turn's inverse gives the input back bit for bit.
- ``RandFlipd``, ``RandRotated`` and ``RandZoomd`` with a per-key ``mode`` (the image
  bilinear, the label nearest) in a ``Compose``, and its inverse.
- ``OneOf``, ``RandomOrder`` and ``SomeOf`` of those dict transforms: the same choices
  (their records' ``index`` and ``applied_order``), outputs and inverses.
- A ``Compose(lazy=True)`` of a flip and a zoom: the same output as the JAX one's, both
  operations pending until the end and applied there; a lazy ``OneOf``'s inverse (the
  JAX one records its choice under the pending operations, and its inverse fails).
- ``Rotate``'s and ``Zoom``'s ``dtype``: the output in the type asked for, in both.
- ``SpatialResample`` onto a diagonal and onto a rotated affine, against the JAX one.
- Resampling on write: the port's ``NiftiWriter`` at the JAX writer's bilinear mode writes
  the JAX writer's file (1e-5 of max|ref|); with nearest and the meta's spatial shape a
  label map written after Orientation and Spacing lies on the input's grid and equals, bit
  for bit, the JAX ``SpatialResample(mode="nearest")`` onto that grid and the ``Invertd``
  route's labels.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import monai_tpu.transforms as JT
import monai_tpu.utils as jax_utils
from monai_tpu.data.image_writer import NiftiWriter as JaxNiftiWriter
from monai_tpu.data.meta_image import MetaImage as JaxMeta
from monai_tpu.data.nifti import read_nifti as jax_read_nifti
import monai_tpu_torch.transforms as TT
import monai_tpu_torch.utils as utils
from monai_tpu_torch.data import MetaImage
from monai_tpu_torch.data.image_writer import NiftiWriter
from monai_tpu_torch.data.nifti import read_nifti

SHAPE = (2, 12, 14, 10)
AFFINE = np.array([[-1.2, 0, 0, 10.0], [0, 0.9, 0, -3.0], [0, 0, 2.5, 4.0], [0, 0, 0, 1]])


def _image(seed=0):
    x = np.random.RandomState(seed).rand(*SHAPE).astype(np.float32)
    return x, MetaImage(torch.from_numpy(x), AFFINE), JaxMeta(jnp.asarray(x), affine=AFFINE)


def _np(img):
    return np.asarray(img.data.numpy() if isinstance(img, MetaImage) else img.data, dtype=np.float64)


def _close(got, want, exact):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if exact:
        assert np.array_equal(g, w)
    else:
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-12)
    np.testing.assert_allclose(got.affine, np.asarray(want.affine), atol=1e-9)


ARRAY = {
    "flip": (lambda m: m.RandFlip(prob=0.5, spatial_axis=(0, 2)), True),
    "rotate": (lambda m: m.RandRotate(range_x=0.4, range_y=0.3, range_z=0.2, prob=0.5), False),
    "rotate90": (lambda m: m.RandRotate90(prob=0.5, max_k=3, spatial_axes=(0, 2)), True),
    "zoom": (lambda m: m.RandZoom(prob=0.5, min_zoom=0.8, max_zoom=1.3, keep_size=True), False),
}


@pytest.mark.parametrize("name", sorted(ARRAY))
def test_random_array_transforms_invert_as_jax(name):
    make, exact = ARRAY[name]
    port, ref = make(TT).set_random_state(seed=5), make(JT).set_random_state(seed=5)
    skips = []
    for call in range(6):
        x, img, jimg = _image(call)
        out, jout = port(img), ref(jimg)
        skipped = bool(out.applied_operations[-1]["extra_info"].get("skipped"))
        assert skipped == bool(jout.applied_operations[-1]["extra_info"].get("skipped"))
        assert out.applied_operations[-1]["class"] == jout.applied_operations[-1]["class"] == type(port).__name__
        skips.append(skipped)
        _close(out, jout, exact)
        back, jback = port.inverse(out), ref.inverse(jout)
        _close(back, jback, exact)
        assert back.applied_operations == [] and len(out.applied_operations) == 1
        if skipped or exact:
            assert np.array_equal(back.data.numpy(), x)
            np.testing.assert_allclose(back.affine, AFFINE, atol=1e-12)
    assert any(skips) and not all(skips)


@pytest.fixture
def determinism():
    """Both packages' global seed: an inverse flattens the Compose into a new one, which
    seeds its transforms again from that seed (in both packages, as in torch MONAI)."""
    utils.set_determinism(seed=0)
    jax_utils.set_determinism(seed=0)
    yield
    utils.set_determinism(seed=None)
    jax_utils.set_determinism(seed=None)


def _dict_pipeline(m, container=None, **kw):
    keys = ["image", "label"]
    ts = [m.RandFlipd(keys, prob=0.7, spatial_axis=1),
          m.RandRotated(keys, range_x=0.3, prob=0.7, mode=["bilinear", "nearest"]),
          m.RandZoomd(keys, prob=0.7, min_zoom=0.8, max_zoom=1.2, mode=["bilinear", "nearest"])]
    if container is not None:
        ts = [getattr(m, container)(ts, **kw)]
    return m.Compose(ts).set_random_state(seed=11)


def _dicts(seed):
    x, img, jimg = _image(seed)
    lab = (x[:1] > 0.5).astype(np.float32)
    return ({"image": img, "label": MetaImage(torch.from_numpy(lab), AFFINE)},
            {"image": jimg, "label": JaxMeta(jnp.asarray(lab), affine=AFFINE)})


@pytest.mark.parametrize("container,kw", [(None, {}), ("OneOf", {"weights": [1, 2, 3]}), ("RandomOrder", {}),
                                          ("SomeOf", {"num_transforms": (1, 3)})])
def test_dict_transforms_and_containers_invert_as_jax(container, kw, determinism):
    port, ref = _dict_pipeline(TT, container, **kw), _dict_pipeline(JT, container, **kw)
    for call in range(4):
        d, jd = _dicts(call)
        out, jout = port(d), ref(jd)
        for key in ("image", "label"):
            ops = [op.get("extra_info") for op in out[key].applied_operations]
            jops = [op.get("extra_info") for op in jout[key].applied_operations]
            assert [o.get("skipped", False) for o in ops] == [o.get("skipped", False) for o in jops]
            if container is not None:  # the container's choice
                pick = {k: v for k, v in ops[-1].items() if k in ("index", "applied_order")}
                assert pick == {k: v for k, v in jops[-1].items() if k in ("index", "applied_order")} and pick
            _close(out[key], jout[key], exact=False)
        back, jback = port.inverse(out), ref.inverse(jout)
        for key in ("image", "label"):
            _close(back[key], jback[key], exact=False)
            assert back[key].applied_operations == []
            assert back[key].shape == d[key].shape


def test_lazy_compose_fuses_as_jax():
    def pipeline(m):
        return m.Compose([m.Flip(spatial_axis=0), m.Zoom(1.25, keep_size=False)], lazy=True)

    _, img, jimg = _image(3)
    out, jout = pipeline(TT)(img), pipeline(JT)(jimg)
    _close(out, jout, exact=False)
    assert out.pending_operations == [] and len(out.applied_operations) == 2
    eager = TT.Compose([TT.Flip(spatial_axis=0), TT.Zoom(1.25, keep_size=False)])(img)
    assert eager.shape == out.shape


@pytest.mark.parametrize("name", ["rotate", "zoom"])
def test_rotate_and_zoom_dtype(name):
    _, img, jimg = _image(4)
    for m, im in ((TT, img), (JT, jimg)):
        t = m.Rotate((0.3, 0.0, 0.1), dtype=np.float16) if name == "rotate" else m.Zoom(1.3, keep_size=False,
                                                                                          dtype=np.float16)
        out = t(im, lazy=True)
        out = (TT.apply_pending if m is TT else JT.apply_pending)(out)[0]
        assert str(out.data.dtype).endswith("float16")
    assert TT.Rotate(0.3).dtype == np.float32 and TT.Zoom(1.1).dtype == np.float32


@pytest.mark.parametrize("rotated", [False, True])
def test_spatial_resample_matches_jax(rotated):
    _, img, jimg = _image(5)
    dst = np.diag([1.5, 1.1, 2.0, 1.0])
    dst[:3, 3] = (9.0, -2.5, 3.5)
    if rotated:
        c, s = np.cos(0.3), np.sin(0.3)
        dst[:3, :3] = dst[:3, :3] @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    out = TT.SpatialResample()(img, dst_affine=dst)
    jout = JT.SpatialResample()(jimg, dst_affine=dst)
    _close(out, jout, exact=False)


def test_resample_on_write_matches_jax_and_invertd(tmp_path):
    x, img, jimg = _image(6)
    pre = TT.Compose([TT.Orientation("RAS"), TT.Spacing((1.5, 1.5, 1.5))])
    jpre = JT.Compose([JT.Orientation("RAS"), JT.Spacing((1.5, 1.5, 1.5))])
    img.meta["original_affine"], jimg.meta["original_affine"] = AFFINE.copy(), AFFINE.copy()
    out, jout = pre(img), jpre(jimg)
    _close(out, jout, exact=False)
    # the JAX writer resamples bilinearly onto the extent that holds the input
    w, jw = NiftiWriter(), JaxNiftiWriter()
    w.set_data_array(out, channel_dim=0)
    w.set_metadata({**out.meta, "spatial_shape": None}, resample=True, mode="bilinear")
    jw.set_data_array(jout, channel_dim=0)
    jw.set_metadata(jout.meta, resample=True)
    w.write(str(tmp_path / "port.nii.gz"))
    jw.write(str(tmp_path / "jax.nii.gz"))
    got, meta = read_nifti(str(tmp_path / "port.nii.gz"))
    want, jmeta = jax_read_nifti(str(tmp_path / "jax.nii.gz"))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(meta["affine"], jmeta["affine"], atol=1e-6)
    # a label map, nearest, onto the meta's spatial shape: the input's grid, the JAX
    # SpatialResample's nearest labels there, and the Invertd route's, bit for bit
    labels = (x[:1] > 0.6).astype(np.float32)
    lab = MetaImage(torch.from_numpy(labels), AFFINE,
                    meta={"original_affine": AFFINE.copy(), "spatial_shape": np.asarray(SHAPE[1:])})
    spaced, jspaced = pre(lab), jpre(JaxMeta(jnp.asarray(labels), affine=AFFINE))
    _close(spaced, jspaced, exact=False)
    w = NiftiWriter()
    w.set_data_array(spaced, channel_dim=0)
    w.set_metadata(spaced.meta, resample=True, mode="nearest")
    w.write(str(tmp_path / "label.nii.gz"))
    written, meta = read_nifti(str(tmp_path / "label.nii.gz"))
    assert written.shape == SHAPE[1:]
    np.testing.assert_allclose(meta["affine"], AFFINE, atol=1e-6)
    want = JT.SpatialResample(mode="nearest")(jspaced, dst_affine=AFFINE, spatial_size=SHAPE[1:])
    assert np.array_equal(written, np.asarray(want.data)[0])
    inverted = TT.Invertd("pred", pre, orig_keys="label")({"pred": spaced.data, "label": spaced})["pred"]
    assert inverted.shape[1:] == SHAPE[1:]
    assert np.array_equal(written, inverted.data[0].numpy())


def test_cache_dataset_options_match_jax():
    from monai_tpu.data import CacheDataset as JaxCacheDataset
    from monai_tpu_torch.data import CacheDataset

    values = (0.5, 1.5, 0.5, 1.5, 3.0)
    data = [{"image": torch.full((1, 4, 4, 4), v)} for v in values]
    jdata = [{"image": np.full((1, 4, 4, 4), v, np.float32)} for v in values]

    def pipeline(m, seed=2):
        return m.Compose([m.ScaleIntensityRanged("image", a_min=0.0, a_max=2.0, b_min=0.0, b_max=1.0),
                          m.RandShiftIntensityd("image", offsets=0.2, prob=1.0)]).set_random_state(seed=seed)

    for kw in ({}, {"hash_as_key": True}, {"runtime_cache": True}, {"hash_as_key": True, "cache_rate": 0.5}):
        ds, jds = CacheDataset(data, pipeline(TT), **kw), JaxCacheDataset(jdata, pipeline(JT), **kw)
        assert ds.cache_num == jds.cache_num
        if kw.get("runtime_cache"):
            assert ds._cache == [None] * ds.cache_num
        for i in range(len(values)):
            got, want = ds[i]["image"], jds[i]["image"]
            np.testing.assert_allclose(_np(got), np.asarray(getattr(want, "data", want)), rtol=0, atol=1e-6)
        assert all(c is not None for c in ds._cache)
    deterministic = TT.Compose([TT.ScaleIntensityRanged("image", a_min=0.0, a_max=2.0, b_min=0.0, b_max=1.0)])
    shared, copied = CacheDataset(data, deterministic, copy_cache=False), CacheDataset(data, deterministic)
    assert shared[1] is shared._cache[1] and copied[1] is not copied._cache[1]
    assert torch.equal(shared[1]["image"].data, copied[1]["image"].data)


@pytest.mark.parametrize("kw", [{"k_divisible": [4, 5, 3]}, {"k_divisible": 6, "mode": "edge", "margin": 2},
                                {"mode": "reflect", "margin": [3, 0, 1], "allow_smaller": False},
                                {"mode": "wrap", "margin": 4, "allow_smaller": False, "k_divisible": 4}])
def test_crop_foreground_options_match_jax(kw):
    x = np.zeros((2, 11, 13, 9), np.float32)
    x[:, 2:7, 1:9, 3:8] = np.random.RandomState(0).rand(2, 5, 8, 5) + 0.5
    img, jimg = MetaImage(torch.from_numpy(x), AFFINE), JaxMeta(jnp.asarray(x), affine=AFFINE)
    out, start, end = TT.CropForeground(return_coords=True, **kw)(img)
    jout, jstart, jend = JT.CropForeground(return_coords=True, **kw)(jimg)
    assert np.array_equal(start, np.asarray(jstart)) and np.array_equal(end, np.asarray(jend))
    _close(out, jout, exact=True)
    k = kw.get("k_divisible", 1)
    assert all(s % kk == 0 for s, kk in zip(out.shape[1:], k if isinstance(k, list) else [k] * 3))
    back = TT.CropForeground(**kw).inverse(out)
    assert back.shape == img.shape


def test_fg_bg_indices_feed_the_crops_as_jax():
    lab = (np.random.RandomState(3).rand(1, 12, 14, 10) > 0.8).astype(np.float32)
    x = np.random.RandomState(4).rand(1, 12, 14, 10).astype(np.float32)
    outs = {}
    for name, m, meta, arr in (("port", TT, MetaImage, torch.from_numpy), ("jax", JT, JaxMeta, jnp.asarray)):
        for with_indices in (False, True):
            d = {"image": meta(arr(x), affine=AFFINE), "label": meta(arr(lab), affine=AFFINE)}
            ts = [m.RandCropByPosNegLabeld(["image", "label"], "label", (4, 5, 3), pos=1, neg=1, num_samples=3,
                                           **({"fg_indices_key": "label_fg_indices",
                                               "bg_indices_key": "label_bg_indices"} if with_indices else {}))]
            if with_indices:
                ts.insert(0, m.FgBgToIndicesd("label"))
            crops = m.Compose(ts).set_random_state(seed=9)(d)
            assert all("label_fg_indices" not in c for c in crops)
            outs[name, with_indices] = [(_np(c["image"]), _np(c["label"])) for c in crops]
    for key in outs:
        assert all(np.array_equal(a, b) and np.array_equal(la, lb)
                   for (a, la), (b, lb) in zip(outs[key], outs["jax", False]))
    fg, bg = TT.FgBgToIndices()(torch.from_numpy(lab))
    jfg, jbg = JT.FgBgToIndices()(jnp.asarray(lab))
    assert np.array_equal(fg, np.asarray(jfg)) and np.array_equal(bg, np.asarray(jbg))
    coords, jcoords = TT.FgBgToIndices(output_shape=lab.shape[1:])(lab), JT.FgBgToIndices(output_shape=lab.shape[1:])(lab)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(coords, jcoords))


def test_rand_shift_intensity_channel_wise_matches_jax():
    x = np.random.RandomState(5).rand(3, 4, 5, 6).astype(np.float32)
    port = TT.RandShiftIntensity(offsets=(0.1, 0.4), prob=0.7, channel_wise=True).set_random_state(seed=1)
    ref = JT.RandShiftIntensity(offsets=(0.1, 0.4), prob=0.7, channel_wise=True).set_random_state(seed=1)
    for call in range(4):
        factor = None if call % 2 else 0.5
        got, want = port(torch.from_numpy(x), factor=factor), ref(jnp.asarray(x), factor=factor)
        assert np.array_equal(np.asarray(got), np.asarray(want)), call
    portd = TT.RandShiftIntensityd("image", offsets=0.3, prob=1.0, channel_wise=True).set_random_state(seed=4)
    refd = JT.RandShiftIntensityd("image", offsets=0.3, prob=1.0, channel_wise=True).set_random_state(seed=4)
    got, want = portd({"image": torch.from_numpy(x)})["image"], refd({"image": jnp.asarray(x)})["image"]
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert len({float(np.asarray(got)[c, 0, 0, 0] - x[c, 0, 0, 0]) for c in range(3)}) == 3


def test_lazy_container_records_above_its_operations():
    """The JAX containers record their choice under a lazy run's operations, and that
    inverse fails; the port's flushes first and inverts."""
    _, img, jimg = _image(7)
    for m, im in ((TT, img), (JT, jimg)):
        c = m.Compose([m.OneOf([m.Flip(spatial_axis=0), m.Zoom(1.2, keep_size=False)])], lazy=True)
        out = c(im)
        if m is JT:
            with pytest.raises(RuntimeError) as e:
                c.inverse(out)
            assert "expected OneOf" in str(e.value.__cause__)
        else:
            back = c.inverse(out)
            assert back.shape == img.shape and back.applied_operations == []
