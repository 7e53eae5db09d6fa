"""monai_tpu_torch as a package: imports without JAX, routes CPU tensors to the plain
versions, and its kernel wrappers refuse what the kernels do not take."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import monai_tpu_torch
from monai_tpu_torch.networks.layers.fast_norm import _split, instance_norm_prelu, instance_norm_prelu_plain
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.ops import _build
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same, conv3d_3x3_same_plain
from monai_tpu_torch.utils import ensure_tuple_rep, fall_back_tuple, get_torch_dtype, to_numpy, to_torch

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import monai_tpu_torch\n"
            "from monai_tpu_torch.networks.nets import UNet\n"
            "from monai_tpu_torch.networks import unet_state_dict_from_jax\n"
            "from monai_tpu_torch.inferers import SlidingWindowInferer\n"
            "from monai_tpu_torch.ops.conv3d import conv3d_3x3_same\n"
            "from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu\n"
            "import monai_tpu_torch.data, monai_tpu_torch.utils, monai_tpu_torch.ops._build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'monai_tpu', 'triton'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_lazy_subpackages():
    assert set(monai_tpu_torch.__all__) == {"data", "inferers", "networks", "ops", "utils"}
    assert monai_tpu_torch.inferers.SlidingWindowInferer is not None
    with pytest.raises(AttributeError):
        monai_tpu_torch.not_a_subpackage


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 3, 4, 5, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 6, 4).astype(np.float32))
    xn = torch.from_numpy(rng.randn(2, 4, 3, 3, 3).astype(np.float32)).contiguous(memory_format=torch.channels_last_3d)
    before = (conv3d_3x3_same.launches, instance_norm_prelu.launches)
    with torch.inference_mode():
        assert torch.equal(conv3d_3x3_same(x, w), conv3d_3x3_same_plain(x, w))
        assert torch.equal(instance_norm_prelu(xn), instance_norm_prelu_plain(xn))
    assert (conv3d_3x3_same.launches, instance_norm_prelu.launches) == before


@pytest.mark.parametrize("x_shape,w_shape,dtype,error", [
    ((1, 3, 4, 5), (3, 3, 3, 5, 4), torch.float32, ValueError),      # x not 5-D
    ((1, 3, 4, 5, 6), (5, 5, 5, 6, 4), torch.float32, ValueError),   # kernel not 3^3
    ((1, 3, 4, 5, 6), (3, 3, 3, 8, 4), torch.float32, ValueError),   # channel mismatch
    ((1, 3, 4, 5, 6), (3, 3, 3, 6, 4), torch.float16, TypeError),    # unsupported dtype
    ((1, 3, 4, 5, 6), (3, 3, 3, 6, 4), torch.float64, TypeError),
])
def test_conv_wrapper_rejects_unsupported(x_shape, w_shape, dtype, error):
    with torch.inference_mode(), pytest.raises(error):
        conv3d_3x3_same(torch.zeros(x_shape, dtype=dtype), torch.zeros(w_shape, dtype=dtype))


def test_conv_wrapper_rejects_mixed_dtype_bias_and_noncontiguous():
    x, w = torch.zeros(1, 3, 4, 5, 6), torch.zeros(3, 3, 3, 6, 4)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            conv3d_3x3_same(x, w.bfloat16())
        with pytest.raises(ValueError):
            conv3d_3x3_same(x, w, torch.zeros(5))
        with pytest.raises(ValueError):
            conv3d_3x3_same(x.transpose(1, 2), w)


@pytest.mark.parametrize("kwargs,error", [
    (dict(x=torch.zeros(2, 4)), ValueError),                                       # no spatial dims
    (dict(x=torch.zeros(1, 4, 3, 3, 3, dtype=torch.float16)), TypeError),         # dtype
    (dict(weight=torch.ones(4)), ValueError),                                      # weight without bias
    (dict(weight=torch.ones(3), bias=torch.zeros(3)), ValueError),                 # wrong width
    (dict(slope=torch.ones(2)), ValueError),                                       # slope neither 1 nor C
])
def test_norm_wrapper_rejects_unsupported(kwargs, error):
    args = dict(x=torch.zeros(1, 4, 3, 3, 3))
    args.update(kwargs)
    with torch.inference_mode(), pytest.raises(error):
        instance_norm_prelu(args.pop("x"), **args)


def test_wrappers_refuse_grad():
    w = torch.zeros(3, 3, 3, 2, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv3d_3x3_same(torch.zeros(1, 2, 2, 2, 2), w)
    with pytest.raises(RuntimeError, match="forward-only"):
        instance_norm_prelu(torch.zeros(1, 2, 3, 3, 3, requires_grad=True))


def test_unet_feeds_the_norm_channels_last(monkeypatch):
    """The norm kernel takes channels-last memory only; every fused site of the bench
    UNet's topology gets it, the first (after a 1-channel strided conv) included."""
    import monai_tpu_torch.networks.blocks.convolutions as conv_mod

    seen = []

    def spy(x, *args, **kwargs):
        seen.append(x.permute(0, 2, 3, 4, 1).is_contiguous())
        return instance_norm_prelu(x, *args, **kwargs)

    monkeypatch.setattr(conv_mod, "instance_norm_prelu", spy)
    net = UNet(3, 1, 2, (4, 4, 4, 4, 4), (2, 2, 2, 2), num_res_units=2).eval()
    with torch.inference_mode():
        net(torch.rand(1, 1, 16, 16, 16))
    assert len(seen) == 17 and all(seen)


def test_norm_split_covers_every_row():
    for batch, s, c in [(18, 96 ** 3, 2), (18, 48 ** 3, 16), (18, 6 ** 3, 256), (1, 7, 3), (2, 1, 100)]:
        block_s, block_c, rows, n_split = _split(batch, s, c)
        assert rows % block_s == 0 and (n_split - 1) * rows < s <= n_split * rows
        assert block_c & (block_c - 1) == 0 and 2 <= block_c <= 64


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """An edited source changes the library's name, so it is built anew."""
    path = _build.library_path()
    assert path.parent == REPO / "build" / "monai_tpu_torch" and path.suffix == ".so"
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC_DIR.glob("*.cu"):
        (src / f.name).write_text(f.read_text())
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    assert _build.library_path() == path
    (src / "conv3d_3x3_same.cu").write_text((src / "conv3d_3x3_same.cu").read_text() + "\n// edit\n")
    assert _build.library_path() != path


def test_utils():
    assert ensure_tuple_rep(3, 2) == (3, 3) and fall_back_tuple((-1, 4), (7, 9)) == (7, 4)
    assert get_torch_dtype("bfloat16") is torch.bfloat16 and get_torch_dtype(np.float32) is torch.float32
    t = to_torch(np.arange(4, dtype=np.float32), dtype="bfloat16")
    assert t.dtype is torch.bfloat16 and to_numpy(t).dtype == np.float32
