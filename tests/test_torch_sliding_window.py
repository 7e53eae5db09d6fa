"""monai_tpu_torch's sliding-window inference against monai_tpu's, on the CPU.

The grid and importance-map helpers must equal the JAX package's exactly. The whole
slice — the small UNet under ``SlidingWindowInferer`` (gaussian, overlap 0.25, roi 16³,
sw_batch_size 4) on a (1, 1, 40, 36, 20) volume — agrees with monai_tpu's inferer and
UNet on the same weights to 1e-4 (absolute and relative; float32, sums in another
order, and the port divides by the count map where the JAX package multiplies by its
reciprocal).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from monai_tpu.data.utils import compute_importance_map as jax_importance_map
from monai_tpu.data.utils import dense_patch_slices as jax_dense_patch_slices
from monai_tpu.inferers import SlidingWindowInferer as JaxSlidingWindowInferer
from monai_tpu.inferers.utils import compute_scan_interval as jax_scan_interval
from monai_tpu.networks.nets import UNet as JaxUNet
from monai_tpu_torch.data.utils import compute_importance_map, dense_patch_slices, get_valid_patch_size
from monai_tpu_torch.inferers import SimpleInferer, SlidingWindowInferer, sliding_window_inference
from monai_tpu_torch.inferers.utils import compute_scan_interval
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.weights import unet_state_dict_from_jax

GRIDS = [((40, 36, 20), (16, 16, 16), 0.25), ((224, 224, 112), (96, 96, 96), 0.25),
         ((7, 9), (4, 4), 0.5), ((10, 10, 10), (10, 10, 10), 0.25), ((33, 17, 8), (16, 16, 8), 0.0)]


@pytest.mark.parametrize("image,roi,overlap", GRIDS)
def test_scan_interval_and_dense_patch_slices_equal_jax(image, roi, overlap):
    nd = len(image)
    interval = compute_scan_interval(image, roi, nd, (overlap,) * nd)
    assert interval == jax_scan_interval(image, roi, nd, (overlap,) * nd)
    for return_slice in (True, False):
        assert dense_patch_slices(image, roi, interval, return_slice) == \
            jax_dense_patch_slices(image, roi, interval, return_slice)


def test_main_path_grid_has_18_windows():
    interval = compute_scan_interval((224, 224, 112), (96, 96, 96), 3, (0.25,) * 3)
    assert len(dense_patch_slices((224, 224, 112), (96, 96, 96), interval)) == 18


@pytest.mark.parametrize("size,mode,sigma", [((16, 16, 16), "gaussian", 0.125), ((96, 96, 96), "gaussian", 0.125),
                                             ((5, 8, 3), "gaussian", (0.25, 0.5, 1.0)),
                                             ((8, 4), "gaussian", 0.01), ((6, 7, 2), "constant", 0.125)])
def test_importance_map_equals_jax(size, mode, sigma):
    got = compute_importance_map(size, mode=mode, sigma_scale=sigma)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jax_importance_map(size, mode=mode, sigma_scale=sigma))


def test_importance_map_min_clamp():
    """A narrow Gaussian underflows at the window's corners; the 1e-3 clamp keeps every
    weight positive."""
    m = compute_importance_map((16, 16), mode="gaussian", sigma_scale=0.01)
    assert float(m.min()) == pytest.approx(1e-3)


def test_valid_patch_size():
    assert get_valid_patch_size((40, 36, 20), (16, 0, 32)) == (16, 36, 20)


def test_whole_slice_matches_jax():
    args = (3, 1, 2, (4, 8, 16), (2, 2))
    jax_net = JaxUNet(*args, num_res_units=2, rngs=nnx.Rngs(0))
    params = {".".join(map(str, p)): np.asarray(v.get_value())
              for p, v in nnx.state(jax_net, nnx.Param).flat_state()}
    port = UNet(*args, num_res_units=2, device="cpu").eval()
    port.load_state_dict(unet_state_dict_from_jax(params))
    vol = np.random.RandomState(0).rand(1, 1, 40, 36, 20).astype(np.float32)
    with torch.inference_mode():
        got = SlidingWindowInferer(16, sw_batch_size=4, overlap=0.25, mode="gaussian")(torch.from_numpy(vol), port)
    ref = JaxSlidingWindowInferer(16, sw_batch_size=4, overlap=0.25, mode="gaussian")(jnp.asarray(vol), jax_net)
    assert got.shape == (1, 2, 40, 36, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_padding_when_roi_exceeds_image_and_constant_blend():
    """An image smaller than the roi is padded symmetrically and cropped back; with an
    identity predictor and constant blending the output is the input."""
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, 5, 12, 7).astype(np.float32))
    out = sliding_window_inference(x, (8, 8, 8), 3, lambda w: w * 1.0, overlap=0.5)
    assert out.shape == x.shape
    torch.testing.assert_close(out, x)


def test_predictor_args_and_simple_inferer():
    x = torch.ones((1, 1, 12, 12, 12))
    out = SlidingWindowInferer(8, sw_batch_size=2, mode="gaussian")(x, lambda w, s: w * s, 3.0)
    torch.testing.assert_close(out, torch.full_like(x, 3.0))
    assert SimpleInferer()(x, lambda w: w + 1).sum().item() == 2 * 12 ** 3


def test_rejects_bad_overlap_and_shape_changing_predictor():
    x = torch.zeros((1, 1, 8, 8, 8))
    with pytest.raises(ValueError):
        sliding_window_inference(x, 4, 1, lambda w: w, overlap=1.0)
    with pytest.raises(ValueError):
        sliding_window_inference(x, 4, 1, lambda w: w[..., :2])
