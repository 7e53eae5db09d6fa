"""The Spleen bundle's inference path in monai_tpu_torch against monai_tpu, on the CPU.

A 64x64x20 int16 CT at affine diag(-0.79, -0.79, 5.0) is written with ``write_nifti``
and run through the bundle's preprocessing (LoadImaged, EnsureChannelFirstd,
Orientationd RAS, Spacingd (1.5, 1.5, 2.0) bilinear, ScaleIntensityRanged -57..164 to
0..1, clipped) in both packages: the shapes, affines (to 1e-9), applied-operation classes
and values (to 1e-5) agree. A small batch-norm UNet(3, 1, 2, (4, 8, 16), (2, 2),
num_res_units=2) with non-trivial running statistics goes through the weight bridge;
under SlidingWindowInferer(32, 4, 0.25) its logits agree to 1e-4 (relative; float32 sums
in another order), and after the postprocessing (softmax, argmax, Invertd at nearest
interpolation) at least 99.9% of the inverted labels agree, on the input's grid and
affine. The JAX nets run in eval mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from monai_tpu.data.nifti import read_nifti as jax_read_nifti
from monai_tpu.inferers import SlidingWindowInferer as JaxSlidingWindowInferer
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu.transforms import compose as jax_compose
from monai_tpu.transforms import dictionary as jax_dict
from monai_tpu_torch.data import MetaImage, read_nifti, write_nifti
from monai_tpu_torch.inferers import SlidingWindowInferer
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same
from monai_tpu_torch.ops.separable_resample import separable_resample_3d
from monai_tpu_torch.transforms import (Activationsd, AsDiscreted, Compose, EnsureChannelFirstd, Invertd,
                                        LoadImaged, Orientationd, ScaleIntensityRanged, Spacingd)
from monai_tpu_torch.utils import resolve_device

AFFINE = np.diag([-0.79, -0.79, 5.0, 1.0])
ARGS = (3, 1, 2, (4, 8, 16), (2, 2))


def _pipelines(ns, **load_kwargs):
    """The bundle's preprocessing and postprocessing, built from one package's classes."""
    pre = ns.Compose([ns.LoadImaged("image", **load_kwargs), ns.EnsureChannelFirstd("image"),
                      ns.Orientationd("image", axcodes="RAS"),
                      ns.Spacingd("image", pixdim=[1.5, 1.5, 2.0], mode="bilinear"),
                      ns.ScaleIntensityRanged("image", a_min=-57, a_max=164, b_min=0.0, b_max=1.0, clip=True)])
    post = ns.Compose([ns.Activationsd("pred", softmax=True), ns.AsDiscreted("pred", argmax=True),
                       ns.Invertd("pred", transform=pre, orig_keys="image", nearest_interp=True)])
    return pre, post


class _Jax:
    Compose = jax_compose.Compose
    LoadImaged, EnsureChannelFirstd = jax_dict.LoadImaged, jax_dict.EnsureChannelFirstd
    Orientationd = jax_dict.Orientationd
    Spacingd, ScaleIntensityRanged = jax_dict.Spacingd, jax_dict.ScaleIntensityRanged
    Activationsd, AsDiscreted, Invertd = jax_dict.Activationsd, jax_dict.AsDiscreted, jax_dict.Invertd


class _Port:
    Compose, LoadImaged, EnsureChannelFirstd, Orientationd = Compose, LoadImaged, EnsureChannelFirstd, Orientationd
    Spacingd, ScaleIntensityRanged = Spacingd, ScaleIntensityRanged
    Activationsd, AsDiscreted, Invertd = Activationsd, AsDiscreted, Invertd


@pytest.fixture(scope="module")
def ct(tmp_path_factory):
    rng = np.random.RandomState(0)
    x, y, z = np.meshgrid(np.linspace(-1, 1, 64), np.linspace(-1, 1, 64), np.linspace(-1, 1, 20), indexing="ij")
    body = np.where(x ** 2 + y ** 2 < 0.8, 40.0, -1000.0) + 120.0 * np.exp(-((x - 0.3) ** 2 + y ** 2 + z ** 2) / 0.1)
    vol = (body + rng.normal(0, 30, body.shape)).astype(np.int16)
    path = tmp_path_factory.mktemp("spleen") / "ct.nii.gz"
    write_nifti(vol, path, affine=AFFINE)
    return str(path), vol


@pytest.fixture(scope="module")
def preprocessed(ct):
    path, _ = ct
    jax_pre, jax_post = _pipelines(_Jax)
    pre, post = _pipelines(_Port, device="cpu")
    return (jax_pre({"image": path}), jax_post), (pre({"image": path}), post)


@pytest.fixture(scope="module")
def nets():
    """The batch-norm UNet in both packages from one set of weights and running statistics."""
    jax_net = JaxUNet(*ARGS, num_res_units=2, norm="batch", rngs=nnx.Rngs(0))
    rng = np.random.RandomState(7)
    for path, var in nnx.state(jax_net, nnx.Param).flat_state():
        if path[-1] in ("bias", "alpha", "scale"):
            var.set_value(jnp.asarray(rng.uniform(0.5, 1.5, var.get_value().shape).astype(np.float32)))
    for path, var in nnx.state(jax_net, nnx.BatchStat).flat_state():
        lo, hi = (-0.3, 0.3) if path[-1] == "mean" else (0.2, 2.0)
        var.set_value(jnp.asarray(rng.uniform(lo, hi, var.get_value().shape).astype(np.float32)))
    jax_net.eval()
    variables = {".".join(map(str, p)): np.asarray(v.get_value())
                 for kind in (nnx.Param, nnx.BatchStat) for p, v in nnx.state(jax_net, kind).flat_state()}
    port = UNet(*ARGS, num_res_units=2, norm="batch", device="cpu")
    port.load_state_dict(unet_state_dict_from_jax(variables), strict=True)
    return jax_net, port.eval()


def test_nifti_round_trip_matches_jax_reader(ct):
    path, vol = ct
    data, meta = read_nifti(path)
    jdata, jmeta = jax_read_nifti(path)
    assert data.dtype == np.int16 and data.flags.writeable
    np.testing.assert_array_equal(data, vol)
    np.testing.assert_array_equal(data, jdata)
    for key in ("affine", "original_affine", "spatial_shape", "pixdim"):
        np.testing.assert_array_equal(meta[key], jmeta[key])
    np.testing.assert_allclose(meta["affine"], AFFINE, atol=1e-6)


def test_preprocessing_matches_jax(preprocessed):
    (jd, _), (d, _) = preprocessed
    jimg, img = jd["image"], d["image"]
    assert isinstance(img, MetaImage) and not isinstance(img, torch.Tensor)
    assert img.data.device.type == "cpu" and img.dtype == torch.float32 and img.affine.dtype == np.float64
    assert img.shape == tuple(jimg.shape) == (1, 34, 34, 48)
    assert np.abs(img.affine - jimg.affine).max() <= 1e-9
    assert [op["class"] for op in img.applied_operations] == [op["class"] for op in jimg.applied_operations] \
        == ["Orientation", "Spacing"]
    assert np.abs(img.as_numpy() - np.asarray(jimg.data)).max() <= 1e-5


def test_batch_norm_unet_keeps_channels_last_and_matches_jax(nets):
    jax_net, port = nets
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, inp: seen.append(inp[0].permute(0, 2, 3, 4, 1).is_contiguous()))
             for m in port.modules() if getattr(m, "same_3x3x3", False)]
    x = np.random.RandomState(3).rand(2, 1, 16, 16, 16).astype(np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    assert len(seen) == 6 and all(seen)  # every 3x3x3 stride-1 conv reads channels-last memory, no copy
    assert sum(isinstance(m, torch.nn.BatchNorm3d) for m in port.modules()) == 9
    np.testing.assert_allclose(got, np.asarray(jax_net(jnp.asarray(x))), atol=1e-4, rtol=1e-4)


def test_whole_path_matches_jax(preprocessed, nets, ct):
    (jd, jax_post), (d, post) = preprocessed
    jax_net, port = nets
    ref = JaxSlidingWindowInferer(32, sw_batch_size=4, overlap=0.25)(jnp.asarray(np.asarray(jd["image"].data)[None]),
                                                                    jax_net)
    before = (conv3d_3x3_same.launches, separable_resample_3d.launches)
    with torch.inference_mode():
        logits = SlidingWindowInferer(32, sw_batch_size=4, overlap=0.25)(d["image"].data[None], port)
        out = post({**d, "pred": logits[0]})["pred"]
    assert (conv3d_3x3_same.launches, separable_resample_3d.launches) == before  # the CPU runs the plain versions
    ref = np.asarray(ref)
    assert logits.shape == ref.shape == (1, 2, 34, 34, 48)
    assert np.abs(logits.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    jout = jax_post({**jd, "pred": ref[0]})["pred"]
    labels, jlabels = out.as_numpy(), np.asarray(jout.data)
    assert out.shape == tuple(jout.shape) == (1, 64, 64, 20)
    file_affine = read_nifti(ct[0])[1]["affine"]  # AFFINE as the header's float32 holds it
    assert np.abs(out.affine - file_affine).max() <= 1e-9 and np.abs(jout.affine - file_affine).max() <= 1e-9
    assert set(np.unique(labels)) <= {0.0, 1.0} and 0 < labels.mean() < 1
    assert (labels == jlabels).mean() >= 0.999
    assert out.applied_operations == []


def test_inverse_at_nearest_returns_labels_to_their_voxels(preprocessed):
    """Invertd at order 0 pulls each output voxel from one input voxel: a label map that
    is constant along the inverted axes comes back exactly."""
    _, (d, post) = preprocessed
    labels = torch.zeros((1, 34, 34, 48))
    labels[:, 10:20] = 1.0
    inv = Invertd("pred", transform=post.transforms[2].transform, orig_keys="image")({**d, "pred": labels})["pred"]
    assert inv.shape == (1, 64, 64, 20) and set(torch.unique(inv.data).tolist()) == {0.0, 1.0}
    assert torch.equal(inv.data, inv.data[:, :, :1, :1].expand_as(inv.data))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNet(*ARGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LoadImaged("image")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_one_seed_gives_the_same_weights_on_any_device():
    """Weights are drawn on the CPU and then moved, so the device does not change them."""
    torch.manual_seed(5)
    a = UNet(*ARGS, num_res_units=2, norm="batch", device="cpu")
    torch.manual_seed(5)
    b = UNet(*ARGS, num_res_units=2, norm="batch", device="meta")
    assert all(t.device.type == "meta" for t in b.state_dict().values())
    torch.manual_seed(5)
    c = UNet(*ARGS, num_res_units=2, norm="batch", device="cpu")
    for (ka, va), (kc, vc) in zip(a.state_dict().items(), c.state_dict().items()):
        assert ka == kc and torch.equal(va, vc)


def test_lazy_spatial_transforms_match_eager_and_jax(ct):
    """With ``lazy=True`` Orientation and Spacing only record their operations;
    ``apply_pending`` runs them (two resamples: nearest and bilinear do not fuse), as the
    JAX package does, to the eager result."""
    from monai_tpu.data.meta_image import MetaImage as JaxMetaImage
    from monai_tpu.transforms.lazy_executor import apply_pending as jax_apply_pending
    from monai_tpu.transforms.spatial_array import Orientation as JaxOrientation
    from monai_tpu.transforms.spatial_array import Spacing as JaxSpacing
    from monai_tpu_torch.transforms import Orientation, Spacing, apply_pending

    _, vol = ct
    x = vol[None].astype(np.float32)
    img = Spacing([1.5, 1.5, 2.0], lazy=True)(Orientation("RAS", lazy=True)(MetaImage(torch.from_numpy(x), AFFINE)))
    assert img.shape == (1, 64, 64, 20) and len(img.pending_operations) == 2
    lazy, applied = apply_pending(img)
    eager = Spacing([1.5, 1.5, 2.0])(Orientation("RAS")(MetaImage(torch.from_numpy(x), AFFINE)))
    jimg = JaxSpacing([1.5, 1.5, 2.0], lazy=True)(JaxOrientation("RAS", lazy=True)(JaxMetaImage(x, AFFINE)))
    jlazy, _ = jax_apply_pending(jimg)
    assert len(applied) == 2 and [op["class"] for op in lazy.applied_operations] == ["Orientation", "Spacing"]
    assert lazy.shape == eager.shape == tuple(jlazy.shape) == (1, 34, 34, 48)
    np.testing.assert_allclose(lazy.affine, jlazy.affine, atol=1e-9)
    np.testing.assert_array_equal(lazy.as_numpy(), eager.as_numpy())
    assert np.abs(lazy.as_numpy() - np.asarray(jlazy.data)).max() <= 1e-5 * np.abs(x).max()
