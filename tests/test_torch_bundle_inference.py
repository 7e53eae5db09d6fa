"""The Spleen bundle's inference.json end to end in both packages, on the CPU: the
slice's parity test.

One 64x64x20 int16 CT (the recipe of tests/test_torch_spleen_inference.py) runs through
``monai_tpu.bundle.run`` and through the port's command line, ``python -m
monai_tpu_torch.bundle run``, with the bundle's own config file: the port's run
overrides ``imports`` and ``initialize`` to name the port, and puts the network, the
loader and the evaluator on the CPU; both override ``roi_size`` to [32, 32, 16] for the
small volume. The same weights go into both: a JAX batch-norm UNet of the bundle's
configuration, built abstractly and given numpy values (running statistics away from 0
and 1), saved as an orbax checkpoint for the JAX run and as a torch file through the
weight bridge for the port's; each run's CheckpointLoader loads them. The two saved
label maps have the same shape and affine (1e-9) and agree on at least 99.9% of the
voxels, and every voxel where they differ has a top-two logit margin in the port's CPU
forward below 1e-4 of the logits' std.

The file names differ, and the port's is the one torch MONAI writes: monai_tpu's Invertd
keeps the prediction's own meta, so its SaveImaged names the file by a running index
(``eval/0/0_seg.nii.gz``), while the port's Invertd carries the image's meta and the file
is ``eval/ct/ct_seg.nii.gz``.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from monai_tpu.bundle import run as jax_run
from monai_tpu.handlers.checkpoint import save_checkpoint
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu_torch.data import read_nifti, write_nifti
from monai_tpu_torch.inferers import SlidingWindowInferer
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax
from monai_tpu_torch.transforms import (Compose, EnsureChannelFirstd, Invertd, LoadImaged, Orientationd,
                                        ScaleIntensityRanged, Spacingd)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "bundles" / "spleen_ct_segmentation" / "configs" / "inference.json"
ROI = [32, 32, 16]
NET = dict(spatial_dims=3, in_channels=1, out_channels=2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2),
           num_res_units=2, norm="batch")
PORT_ARGS = {"imports": ["$import os", "$import glob", "$from monai_tpu_torch.handlers import from_engine"],
             "initialize": ["$import monai_tpu_torch", "$monai_tpu_torch.utils.set_determinism(seed=123)"],
             "network::device": "cpu", "preprocessing::transforms::0::device": "cpu", "evaluator::device": "cpu",
             "dataloader::num_workers": 2, "roi_size": ROI}
OUT_BIAS = "model.2.1.conv.unit0.conv.bias"  # the output conv's, in the port's state_dict


def write_ct(path: Path) -> None:
    rng = np.random.RandomState(0)
    x, y, z = np.meshgrid(np.linspace(-1, 1, 64), np.linspace(-1, 1, 64), np.linspace(-1, 1, 20), indexing="ij")
    body = np.where(x ** 2 + y ** 2 < 0.8, 40.0, -1000.0) + 120.0 * np.exp(-((x - 0.3) ** 2 + y ** 2 + z ** 2) / 0.1)
    path.parent.mkdir(parents=True)
    write_nifti((body + rng.normal(0, 30, body.shape)).astype(np.int16), path, affine=np.diag([-0.79, -0.79, 5.0, 1.0]))


def preprocessing():
    return Compose([LoadImaged("image", device="cpu"), EnsureChannelFirstd("image"), Orientationd("image", axcodes="RAS"),
                    Spacingd("image", pixdim=[1.5, 1.5, 2.0], mode="bilinear"),
                    ScaleIntensityRanged("image", a_min=-57, a_max=164, b_min=0.0, b_max=1.0, clip=True)])


def port_logits(image: torch.Tensor, state: dict) -> torch.Tensor:
    """The port's CPU forward of the bundle's UNet with ``state`` under the bundle's
    sliding window (at ``ROI``)."""
    net = UNet(**NET, device="cpu")
    net.load_state_dict(state)
    with torch.inference_mode():
        return SlidingWindowInferer(ROI, sw_batch_size=4, overlap=0.25)(image[None], net.eval())[0]


def filled_jax_unet(image: torch.Tensor):
    """The bundle's UNet in monai_tpu, built abstractly and filled from numpy; the output
    conv's bias of class 1 set so that the port's CPU forward labels half of ``image``'s
    voxels 1 (random weights alone label them all alike). Returns the net and its
    {variable path: array}."""
    net = nnx.eval_shape(lambda: JaxUNet(**NET, rngs=nnx.Rngs(0)))
    rng = np.random.RandomState(5)
    variables = {}
    for path, var in nnx.state(net).flat_state():
        shape, kind, leaf = var.get_value().shape, type(var).__name__, path[-1]
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
            continue
        if kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
            continue
        if leaf == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "alpha":
            a = rng.uniform(0.1, 0.4, shape)
        else:  # bias, mean
            a = rng.uniform(-0.2, 0.2, shape)
        variables[".".join(map(str, path))] = a.astype(np.float32)
    out_bias = next(k for k in variables if list(unet_state_dict_from_jax({k: variables[k]})) == [OUT_BIAS])
    variables[out_bias][:] = 0.0
    logits = port_logits(image, unet_state_dict_from_jax(variables))
    variables[out_bias][1] = -float((logits[1] - logits[0]).median())
    for path, var in nnx.state(net).flat_state():
        key = ".".join(map(str, path))
        if key in variables:
            var.set_value(jnp.asarray(variables[key]))
    return net, variables


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs of inference.json over one CT with one set of weights: (the JAX root,
    the port's root, the weights, the port's command's output)."""
    jax_root, port_root = (tmp_path_factory.mktemp(n) for n in ("jax_bundle", "port_bundle"))
    for root in (jax_root, port_root):
        write_ct(root / "data" / "Task09_Spleen" / "imagesTs" / "ct.nii.gz")
        (root / "models").mkdir()
    image = preprocessing()({"image": str(port_root / "data" / "Task09_Spleen" / "imagesTs" / "ct.nii.gz")})["image"]
    net, variables = filled_jax_unet(image.data)
    save_checkpoint({"model": net}, str(jax_root / "models" / "model_final.ckpt"))
    state = unet_state_dict_from_jax(variables)
    torch.save({"model": state}, port_root / "models" / "model_final.ckpt")

    jax_run(config_file=str(CONFIG), bundle_root=str(jax_root), roi_size=ROI)
    cmd = [sys.executable, "-m", "monai_tpu_torch.bundle", "run", "--config_file", str(CONFIG),
           "--bundle_root", str(port_root)]
    for key, value in PORT_ARGS.items():
        cmd += [f"--{key}", value if isinstance(value, str) else json.dumps(value)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return jax_root, port_root, state, proc.stdout


def test_both_runs_write_one_label_map(runs):
    jax_root, port_root, _, stdout = runs
    port_files = [str(p.relative_to(port_root)) for p in port_root.rglob("*_seg.nii.gz")]
    jax_files = [str(p.relative_to(jax_root)) for p in jax_root.rglob("*_seg.nii.gz")]
    assert port_files == ["eval/ct/ct_seg.nii.gz"] and jax_files == ["eval/0/0_seg.nii.gz"]
    assert f"writing: {port_root}/eval/ct/ct_seg.nii.gz" in stdout


def test_label_maps_match_jax(runs):
    jax_root, port_root, state, _ = runs
    labels, meta = read_nifti(port_root / "eval" / "ct" / "ct_seg.nii.gz")
    jlabels, jmeta = read_nifti(jax_root / "eval" / "0" / "0_seg.nii.gz")
    image_affine = read_nifti(port_root / "data" / "Task09_Spleen" / "imagesTs" / "ct.nii.gz")[1]["affine"]
    assert labels.dtype == jlabels.dtype == np.float32 and labels.shape == jlabels.shape == (64, 64, 20)
    assert np.abs(meta["affine"] - jmeta["affine"]).max() <= 1e-9 and np.abs(meta["affine"] - image_affine).max() <= 1e-9
    assert set(np.unique(labels)) == {0.0, 1.0} and 0.01 < labels.mean() < 0.99
    differ = labels != jlabels
    assert 1 - differ.mean() >= 0.999

    # the port's CPU forward of the same weights: each differing voxel's top-two margin,
    # taken back to the file's grid by the bundle's own inverse at nearest interpolation
    pre = preprocessing()
    d = pre({"image": str(port_root / "data" / "Task09_Spleen" / "imagesTs" / "ct.nii.gz")})
    logits = port_logits(d["image"].data, state)
    margin = (logits[1] - logits[0]).abs()[None]
    margin = Invertd("pred", transform=pre, orig_keys="image")({**d, "pred": margin})["pred"].as_numpy()[0]
    np.testing.assert_array_equal(labels, Invertd("pred", transform=pre, orig_keys="image")(
        {**d, "pred": logits.argmax(0, keepdim=True).float()})["pred"].as_numpy()[0])
    assert (margin[differ] < 1e-4 * logits.std().item()).all(), np.sort(margin[differ])[-5:]
