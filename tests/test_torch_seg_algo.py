"""Auto3DSeg's in-code trainer ``SegAlgo`` in monai_tpu_torch against monai_tpu's, on the
CPU.

- The same networks: the UNet and the SegResNet it builds for three labels have the
  state-dict keys that ``networks.weights`` maps the JAX ones to.
- The same crops: the training pipeline (median spacing 1.5 x 1 x 2 mm, foreground
  normalisation, two 16^3 crops an item, a flip) under the same seeds, the images within
  1e-5 of max|ref| (the port normalises in float64) and the labels exactly.
- One training step (one item of a 32^3 phantom, its two crops a batch) from the JAX UNet's
  weights carried over: its loss within 1e-4 of the JAX net's ``DiceCELoss`` on the same
  crops; ``result.json`` holds the negative of the last loss and the checkpoint loads.
- ``predict`` with carried weights (Gaussian sliding window over 16^3 windows) within
  1e-4 of max|ref| of the JAX ``predict``. The phantom carries noise: a window of exact
  zeros (a noiseless phantom's corner) goes through instance norms of constant inputs,
  which scale the two packages' rounding by 1/sqrt(eps), and there they differ by up to
  ~40% of max|ref|, whichever is run.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

import monai_tpu.apps.auto3dseg as jax_a3d
import monai_tpu.utils as jax_utils
from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
import monai_tpu_torch.utils as utils
from monai_tpu_torch.apps import auto3dseg as a3d
from monai_tpu_torch.data import write_nifti
from monai_tpu_torch.data.synthetic import create_test_image_3d
from monai_tpu_torch.networks.weights import segresnet_state_dict_from_jax, unet_state_dict_from_jax

STATS = {"stats_summary": {"image_stats": {"spacing": {"median": [1.5, 1.0, 2.0]}},
                           "label_stats": {"labels": [0, 1, 2]}}}
ROI = (16, 16, 16)


@pytest.fixture(scope="module")
def item(tmp_path_factory):
    root = tmp_path_factory.mktemp("segalgo")
    im, seg = create_test_image_3d(32, 32, 32, num_objs=4, rad_max=7, rad_min=3, num_seg_classes=2, noise_max=0.2,
                                   random_state=np.random.RandomState(8))
    out = {"image": str(root / "img.nii.gz"), "label": str(root / "seg.nii.gz")}
    write_nifti(im.astype(np.float32), out["image"])
    write_nifti(seg.astype(np.uint8), out["label"])
    return out


def _algos(tmp_path, network, datalist=()):
    common = dict(data_stats=STATS, datalist=list(datalist), roi_size=ROI)
    return (jax_a3d.SegAlgo(f"{network}_0", network, str(tmp_path / "jax"), **common),
            a3d.SegAlgo(f"{network}_0", network, str(tmp_path / "port"), device="cpu", **common))


def _jax_net_and_weights(algo, seed=5):
    """The JAX algo's network, built abstractly, its parameters drawn with numpy."""
    net = nnx.eval_shape(algo.build_network)
    rng = np.random.RandomState(seed)
    variables = {}
    for path, var in nnx.state(net).flat_state():
        kind, shape = type(var).__name__, var.get_value().shape
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
        elif kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
        else:
            lo, hi = (0.5, 1.5) if path[-1] == "scale" else (-0.3, 0.3)
            variables[".".join(map(str, path))] = value = rng.uniform(lo, hi, shape).astype(np.float32)
            var.set_value(jnp.asarray(value))
    algo._net = net
    return net, variables


BRIDGES = {"unet": unet_state_dict_from_jax, "segresnet": segresnet_state_dict_from_jax}


@pytest.mark.parametrize("network", ["unet", "segresnet"])
def test_seg_algo_builds_the_jax_network(tmp_path, network):
    ref, algo = _algos(tmp_path, network)
    _, variables = _jax_net_and_weights(ref)
    net = algo.build_network()
    assert net.state_dict().keys() == BRIDGES[network](variables).keys()
    assert net.out_channels == 3 if hasattr(net, "out_channels") else True


@pytest.mark.parametrize("seed", [0, 3])
def test_seg_algo_crops_match_jax(tmp_path, item, seed):
    ref, algo = _algos(tmp_path, "unet")
    jax_utils.set_determinism(seed=seed)
    ref_pipe = ref.get_transforms()
    utils.set_determinism(seed=seed)
    pipe = algo.get_transforms()
    for _ in range(2):
        want, got = ref_pipe(dict(item)), pipe(dict(item))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for key, tol in (("image", 1e-5), ("label", 0.0)):
                a, b = np.asarray(w[key].data), g[key].data.numpy()
                assert a.shape == b.shape == (1, *ROI)
                assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-12), key


def test_seg_algo_step_and_predict_match_jax(tmp_path, item, monkeypatch):
    ref, algo = _algos(tmp_path, "unet", [item])
    jax_net, variables = _jax_net_and_weights(ref)
    graphdef, state = nnx.split(jax_net)

    # the first step's loss: the port's train from the carried weights, the JAX loss on the
    # same crops (the first item's two, drawn under the same seed)
    def carried():
        net = a3d.SegAlgo.build_network(algo)
        net.load_state_dict(unet_state_dict_from_jax(variables))
        return net

    monkeypatch.setattr(algo, "build_network", carried)
    jax_utils.set_determinism(seed=2)
    crops = ref.get_transforms()(dict(item))
    x = jnp.asarray(np.stack([np.asarray(c["image"].data) for c in crops]))
    y = jnp.asarray(np.stack([np.asarray(c["label"].data) for c in crops]))
    logits = jax.jit(lambda s, a: nnx.merge(graphdef, s)(a))(state, x)
    want = float(JaxDiceCELoss(to_onehot_y=True, softmax=True)(logits, y))
    utils.set_determinism(seed=2)
    result = algo.train({"max_epochs": 1, "batch_size": 1, "lr": 1e-3})
    assert len(result["loss_history"]) == 1
    assert abs(result["loss_history"][0] - want) <= 1e-4 * abs(want)
    assert json.loads((tmp_path / "port" / "result.json").read_text()) == {"best_metric": -result["loss_history"][0]}
    state_dict = torch.load(os.path.join(algo.get_output_path(), "model", "model_final.pt"), weights_only=True)
    assert all(torch.equal(v, algo._net.state_dict()[k]) for k, v in state_dict["model"].items())

    # predict with the carried weights
    algo._net = carried()
    want = ref.predict({"files": [item["image"]]})[0]
    got = algo.predict({"files": [item["image"]]})[0]
    assert tuple(got.shape) == want.shape == (1, 3, 32, 32, 32)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
