"""monai_tpu_torch as a package: imports without JAX, routes CPU tensors to the plain
versions, its kernel wrappers refuse what the kernels do not take, and an installed copy
ships every kernel source and builds somewhere it can write."""
import glob
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import monai_tpu_torch
from monai_tpu_torch.networks.layers.fast_norm import (H100, instance_norm_plan, instance_norm_prelu,
                                                      instance_norm_prelu_plain)
from monai_tpu_torch.networks.nets import UNet
from monai_tpu_torch.networks.layers import filtering as filtering_layers
from monai_tpu_torch.networks.layers import TrainableBilateralFilter, TrainableJointBilateralFilter
from monai_tpu_torch.ops import _build
from monai_tpu_torch.ops.bilateral import bilateral_stencil, bilateral_stencil_plain
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same, conv3d_3x3_same_plain
from monai_tpu_torch.ops.filtering import bilateral_filter
from monai_tpu_torch.utils import ensure_tuple_rep, fall_back_tuple, get_torch_dtype, to_numpy, to_torch

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import monai_tpu_torch\n"
            "from monai_tpu_torch.networks.nets import SwinUNETR, UNet\n"
            "from monai_tpu_torch.networks import swin_state_dict_from_jax, unet_state_dict_from_jax\n"
            "from monai_tpu_torch.inferers import SlidingWindowInferer, SlidingWindowInfererAdapt\n"
            "from monai_tpu_torch.ops.conv3d import conv3d_3x3_same\n"
            "from monai_tpu_torch.ops.window_attention import fused_window_attention\n"
            "from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu\n"
            "from monai_tpu_torch.ops.separable_resample import separable_resample_3d\n"
            "from monai_tpu_torch.transforms import Compose, Invertd, LoadImaged, Spacingd\n"
            "from monai_tpu_torch.data import MetaImage, NiftiReader, read_nifti, write_nifti\n"
            "import monai_tpu_torch.transforms.dictionary, monai_tpu_torch.transforms.lazy_executor\n"
            "import monai_tpu_torch.data, monai_tpu_torch.utils, monai_tpu_torch.ops._build\n"
            "from monai_tpu_torch.ops.bilateral import bilateral_stencil\n"
            "from monai_tpu_torch.ops.filtering import bilateral_filter, bilateral_grid_filter, phl_filter\n"
            "import monai_tpu_torch.ops.gaussian, monai_tpu_torch.ops.resample, monai_tpu_torch.ops.permutohedral\n"
            "from monai_tpu_torch.networks.layers import (BilateralFilter, PHLFilter, TrainableBilateralFilter,\n"
            "                                             TrainableJointBilateralFilter)\n"
            "from monai_tpu_torch.networks.blocks import CRF\n"
            "from monai_tpu_torch.networks import filter_state_dict_from_jax\n"
            "from monai_tpu_torch.engines import Events, IterationEvents, State, SupervisedTrainer, Workflow\n"
            "from monai_tpu_torch.engines import default_prepare_batch\n"
            "from monai_tpu_torch.losses import DiceCELoss, DiceLoss\n"
            "from monai_tpu_torch.metrics import CumulativeIterationMetric, DiceMetric, compute_dice\n"
            "from monai_tpu_torch.metrics import do_metric_reduction, ignore_background\n"
            "from monai_tpu_torch.networks.utils import amp_model_view, cast_params_to_compute, one_hot\n"
            "from monai_tpu_torch.ops.conv3d import conv3d_3x3_wgrad\n"
            "from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu_backward\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'monai_tpu', 'triton'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_lazy_subpackages():
    assert set(monai_tpu_torch.__all__) == {"data", "engines", "inferers", "losses", "metrics", "networks", "ops",
                                            "transforms", "utils"}
    assert monai_tpu_torch.inferers.SlidingWindowInferer is not None
    with pytest.raises(AttributeError):
        monai_tpu_torch.not_a_subpackage


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 3, 4, 5, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 6, 4).astype(np.float32))
    xn = torch.from_numpy(rng.randn(2, 4, 3, 3, 3).astype(np.float32)).contiguous(memory_format=torch.channels_last_3d)
    before = (conv3d_3x3_same.launches, instance_norm_prelu.launches, bilateral_stencil.launches)
    with torch.inference_mode():
        assert torch.equal(conv3d_3x3_same(x, w), conv3d_3x3_same_plain(x, w))
        assert torch.equal(instance_norm_prelu(xn), instance_norm_prelu_plain(xn))
        for img in (x[:, :1], x[:, :2, 0]):  # 3-D and 2-D
            assert torch.equal(bilateral_filter(img, 1.0, 0.5), bilateral_stencil_plain(img, 1.0, 0.5))
    assert (conv3d_3x3_same.launches, instance_norm_prelu.launches, bilateral_stencil.launches) == before


@pytest.mark.parametrize("x_shape,w_shape,dtype,error", [
    ((1, 3, 4, 5), (3, 3, 3, 5, 4), torch.float32, ValueError),      # x not 5-D
    ((1, 3, 4, 5, 6), (5, 5, 5, 6, 4), torch.float32, ValueError),   # kernel not 3^3
    ((1, 3, 4, 5, 6), (3, 3, 3, 8, 4), torch.float32, ValueError),   # channel mismatch
    ((1, 3, 4, 5, 6), (3, 3, 3, 6, 4), torch.int32, TypeError),      # unsupported dtype
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
    (dict(x=torch.zeros(1, 4, 3, 3, 3, dtype=torch.float64)), TypeError),         # dtype
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
    """The bilateral stencil has no backward; the conv and norm wrappers have one (below),
    and window attention's refusal is tests/test_torch_window_attention.py's."""
    with pytest.raises(RuntimeError, match="forward-only"):
        bilateral_stencil(torch.zeros(1, 1, 4, 4, 4, requires_grad=True))


def test_conv_wrapper_gives_grads():
    x = torch.randn(1, 2, 3, 4, 2, requires_grad=True)
    w = torch.randn(3, 3, 3, 2, 3, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    before = conv3d_3x3_same.launches
    conv3d_3x3_same(x, w, b).square().sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape and t.grad.abs().max() > 0 for t in (x, w, b))
    assert conv3d_3x3_same.launches == before  # CPU tensors: the plain versions


def test_norm_wrapper_gives_grads():
    x = torch.randn(2, 3, 3, 4, 5, requires_grad=True)
    w, b, a = (torch.rand(3) + 0.5).requires_grad_(), torch.randn(3).requires_grad_(), torch.rand(1).requires_grad_()
    (instance_norm_prelu(x, w, b, a) * torch.randn(2, 3, 3, 4, 5)).sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape and t.grad.abs().max() > 0 for t in (x, w, b, a))


def test_trainable_filters_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TrainableBilateralFilter, TrainableJointBilateralFilter):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(1.0)
        f = cls((1.0, 2.0), device="cpu")
        assert {p.device.type for p in f.parameters()} == {"cpu"}
    seen = []
    monkeypatch.setattr(filtering_layers, "resolve_device", lambda d: seen.append(d) or torch.device("cpu"))
    TrainableBilateralFilter(1.0)
    TrainableJointBilateralFilter(1.0)
    assert seen == [None, None]


def test_unet_feeds_the_norm_channels_last(monkeypatch):
    """The norm kernel takes channels-last memory only; every fused site of the bench
    UNet's topology gets it, the first (after a 1-channel strided conv) included."""
    import monai_tpu_torch.networks.blocks.convolutions as conv_mod

    seen = []

    def spy(x, *args, **kwargs):
        seen.append(x.permute(0, 2, 3, 4, 1).is_contiguous())
        return instance_norm_prelu(x, *args, **kwargs)

    monkeypatch.setattr(conv_mod, "instance_norm_prelu", spy)
    net = UNet(3, 1, 2, (4, 4, 4, 4, 4), (2, 2, 2, 2), num_res_units=2, device="cpu").eval()
    with torch.inference_mode():
        net(torch.rand(1, 1, 16, 16, 16))
    assert len(seen) == 17 and all(seen)


# (batch, channels, voxels) of every norm site of the UNet (18 windows) and SwinUNETR (6)
# paths, and two odd shapes
NORM_SITES = [(18, 2, 96 ** 3), (18, 16, 48 ** 3), (18, 32, 24 ** 3), (18, 64, 12 ** 3), (18, 128, 6 ** 3),
              (18, 256, 6 ** 3), (6, 24, 96 ** 3), (6, 24, 48 ** 3), (6, 48, 24 ** 3), (6, 96, 12 ** 3),
              (6, 192, 6 ** 3), (6, 384, 3 ** 3), (1, 3, 7), (2, 100, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("batch,c,s", NORM_SITES)
def test_norm_plan_covers_every_element(batch, c, s, dtype):
    """The plan's vectors cover each element of an instance exactly once, each thread's
    lanes keep their channels, an on-chip slab fits a block's shared memory, the
    persistent grid's unit groups cover every unit, and the loads are 16 bytes wherever C
    allows."""
    p = instance_norm_plan(batch, c, s, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    vfull, vec, g, gv = 16 // elem, p["vec"], p["group"], p["phases"]
    if c % vfull == 0 or (vfull % c == 0 and (s * c) % vfull == 0):
        assert p["vec_bytes"] == 16 and p["path"] != "general"
    assert p["vec_bytes"] == vec * elem and p["groups"] * g == c and (s * g) % vec == 0
    # every vector of every unit of one instance: its first element, as the kernel addresses it
    nvec = s * g // vec
    i = np.arange(nvec, dtype=np.int64)
    rowstride = gv * vec if g == c else c
    starts = np.concatenate([u * g + i // gv * rowstride + i % gv * vec for u in range(p["groups"])])
    assert np.array_equal(np.sort(starts), np.arange(0, s * c, vec))
    # a thread's vectors all have its phase k = i % gv, and lane j holds channel u*G + (k*vec + j) % G
    assert p["threads"] % gv == 0 and p["threads"] <= 256
    for u in range(p["groups"]):
        first = u * g + i[: 4 * gv] // gv * rowstride + i[: 4 * gv] % gv * vec
        for j in range(vec):
            assert np.array_equal((first + j) % c, u * g + ((i[: 4 * gv] % gv) * vec + j) % g)
    units = batch * p["groups"]
    if p["path"] == "onchip":
        assert p["blocks"] == units and s * g * elem <= p["smem"] <= H100[1]
        assert p["smem"] == s * g * elem + 4 * (2 * p["threads"] * vec + 2 * max(p["threads"], g) + 6 * g)
    else:
        upg, per_unit = p["units_per_group"], p["per_unit"]
        assert (p["unit_groups"] - 1) * upg < units <= p["unit_groups"] * upg
        assert p["blocks"] == per_unit * upg and (per_unit * p["threads"]) % gv == 0
        assert per_unit * p["threads"] * _cdiv(nvec, per_unit * p["threads"]) >= nvec
        assert p["scratch"] == 2 * units * per_unit * g + 2 and p["smem"] <= H100[1]
        scratch = 16 * _cdiv(2 * p["threads"] * vec + 2 * max(p["threads"], g) + 6 * g, 4)
        assert p["smem"] == scratch + 16 * p["stash"] * p["threads"]
        assert p["stash"] <= _cdiv(nvec, per_unit * p["threads"]) and (vec > 1 or p["stash"] == 0)
    assert p["path"] == "general" or vec == vfull


def _cdiv(a, b):
    return -(-a // b)


def test_norm_plan_paths_at_the_path_sites():
    """bfloat16: the sites that fit a block's shared memory take one on-chip pass, the
    rest the persistent grid, one 42.5 MB instance a group at the widest Swin site."""
    plans = {(b, c, s): instance_norm_plan(b, c, s, torch.bfloat16) for b, c, s in NORM_SITES}
    onchip = {k for k, p in plans.items() if p["path"] == "onchip"}
    assert onchip == {(18, 64, 12 ** 3), (18, 128, 6 ** 3), (18, 256, 6 ** 3), (6, 96, 12 ** 3), (6, 192, 6 ** 3),
                      (6, 384, 3 ** 3)}
    assert plans[6, 24, 96 ** 3]["units_per_group"] == 1 and plans[6, 24, 96 ** 3]["unit_groups"] == 6
    assert all(p["stash"] > 0 for k, p in plans.items() if p["path"] == "persistent")
    assert plans[1, 3, 7]["path"] == plans[2, 100, 1]["path"] == "general"
    assert instance_norm_plan(18, 2, 96 ** 3, torch.bfloat16, aligned=False)["path"] == "general"


@pytest.mark.parametrize("edited", ["conv3d_3x3_same.cu", "mma_sync.cuh"])
def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch, edited):
    """An edited source, or the header the sources share, changes the library's name, so
    it is built anew."""
    path = _build.library_path()
    assert path.parent == REPO / "build" / "monai_tpu_torch" and path.suffix == ".so"
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC_DIR.glob("*.cu*"):  # the sources and the header they share
        (src / f.name).write_text(f.read_text())
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    assert _build.library_path() == path
    (src / edited).write_text((src / edited).read_text() + "\n// edit\n")
    assert _build.library_path() != path


def test_backward_kernels_refuse_a_second_derivative():
    """The backward kernels have no backward of their own: a graph of the grads raises."""
    x = torch.randn(1, 2, 3, 4, 2, requires_grad=True)
    w = torch.randn(3, 3, 3, 2, 2, requires_grad=True)
    xn = torch.randn(1, 2, 3, 4, 5, requires_grad=True)
    for out, inp in ((conv3d_3x3_same(x, w), x), (instance_norm_prelu(xn, slope=torch.full((1,), 0.25)), xn)):
        (g,) = torch.autograd.grad(out.square().sum(), inp, create_graph=True)
        with pytest.raises(RuntimeError, match="differentiate twice"):
            g.square().sum().backward()


def _globs_match(name: str) -> bool:
    """``csrc/<name>`` is shipped by the port's package_data globs in setup.py."""
    text = (REPO / "setup.py").read_text()
    globs = re.search(r'"monai_tpu_torch":\s*\[([^\]]*)\]', text).group(1)
    return any(Path("csrc", name).match(g.strip().strip('"')) for g in globs.split(","))


def test_package_data_ships_every_kernel_source_and_header():
    """An installed copy builds from what setup.py ships: every file that the library's
    hash reads, and every header that a source includes."""
    hashed = [p.name for p in _build.CSRC_DIR.glob("*.cu*")]
    included = {m for p in _build.CSRC_DIR.glob("*.cu*") for m in re.findall(r'#include "([^"]+)"', p.read_text())}
    assert "mma_sync.cuh" in included and "conv3d_3x3_wgrad.cu" in hashed
    assert all(_globs_match(n) for n in [*hashed, *included])
    assert all((_build.CSRC_DIR / n).is_file() for n in included)


def _load_build_copy(tmp_path: Path):
    """``ops/_build.py`` of a copy of the package under tmp_path/site-packages (no checkout
    around it), loaded as a module of its own."""
    pkg = tmp_path / "site-packages" / "monai_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    shutil.copy(REPO / "monai_tpu_torch" / "ops" / "_build.py", pkg / "ops" / "_build.py")
    shutil.copytree(_build.CSRC_DIR, pkg / "csrc")
    spec = importlib.util.spec_from_file_location("_build_copy", pkg / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, pkg


def test_installed_copy_builds_into_a_writable_cache(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    mod, pkg = _load_build_copy(tmp_path)
    assert mod.CSRC_DIR == pkg / "csrc"
    assert mod.BUILD_DIR == cache / "monai_tpu_torch" / "build"
    assert mod.library_path().parent == mod.BUILD_DIR and mod._writable(mod.BUILD_DIR)
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert mod.build_dir() == tmp_path / "home" / ".cache" / "monai_tpu_torch" / "build"


def test_build_dir_falls_back_and_raises_where_nothing_is_writable(tmp_path, monkeypatch):
    """A checkout whose build/ cannot be written builds into the cache; with no writable
    place at all, the build raises rather than failing later."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    local = REPO / "build" / "monai_tpu_torch"
    monkeypatch.setattr(_build, "_writable", lambda p: p != local)
    assert _build.build_dir() == tmp_path / "cache" / "monai_tpu_torch" / "build"
    monkeypatch.setattr(_build, "_writable", lambda p: False)
    with pytest.raises(RuntimeError, match="writable"):
        _build.build_dir()


def test_utils():
    assert ensure_tuple_rep(3, 2) == (3, 3) and fall_back_tuple((-1, 4), (7, 9)) == (7, 4)
    assert get_torch_dtype("bfloat16") is torch.bfloat16 and get_torch_dtype(np.float32) is torch.float32
    t = to_torch(np.arange(4, dtype=np.float32), dtype="bfloat16")
    assert t.dtype is torch.bfloat16 and to_numpy(t).dtype == np.float32
