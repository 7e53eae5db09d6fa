"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports no JAX,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, relative to max|plain output|: float32 1e-4 (sums in another order);
bfloat16 1e-2 (both versions round an f32 sum to bf16, so they may differ by one bf16
step, at most 2^-7 of the value); float16 2e-3 (one float16 step, 2^-10 of the value). The separable resample: 1e-5 at orders 1 and 3 (2 or 4
taps a row, summed in another order than the dense product), bit-identical at order 0.
The backward kernels (the conv's weight gradient, dx on the conv kernel, the norm's
backward, the window attention's dq, dk, dv and dbias) take the same tolerances as the
forward ones: sums in another order, rounded once to the output type.
The bilateral stencil: 1e-5 (float32 sums of up to (2r+1)^sd taps in another order and
exp on the card); a bfloat16 or float16 input is cast to float32 and its output back, so
it may differ from the float32 result by one rounding of the output type.
"""
import ctypes
import math

import pytest
import torch

import numpy as np

from monai_tpu_torch.networks.layers import fast_norm
from monai_tpu_torch.networks.layers.fast_norm import (H100, _backward_args, _card, _forward, instance_norm_backward_plan,
                                                      instance_norm_plan, instance_norm_prelu,
                                                      instance_norm_prelu_backward, instance_norm_prelu_backward_plain,
                                                      instance_norm_prelu_plain)
from monai_tpu_torch.networks.nets import SegResNet, SwinUNETR, UNet
from monai_tpu_torch.ops.bilateral import (PAIR_RADIUS, PAIR_RESIDENT, bilateral_exps, bilateral_plan,
                                           bilateral_stencil, bilateral_stencil_plain, card_resident)
from monai_tpu_torch.ops.conv3d import (conv3d_3x3_same, conv3d_3x3_same_plain, conv3d_3x3_wgrad,
                                        conv3d_3x3_wgrad_plain, conv3d_3x3_wgrad_plan, wgrad_plan)
from monai_tpu_torch.ops.filtering import bilateral_filter
from monai_tpu_torch.ops.separable_resample import resample_plan, separable_resample_3d, separable_resample_3d_plain
from monai_tpu_torch.ops.window_attention import (_forward as _attention_forward, attention_bwd_plan,
                                                  attention_fwd_plan, fused_window_attention, fused_window_attention_backward,
                                                  fused_window_attention_backward_plain, fused_window_attention_plain,
                                                  window_attention_backward_plan, window_attention_plan)

# every conv site of the two training steps, and of the BraTS and Spleen bundles' float32 steps
from test_torch_conv3d_wgrad_plan import F32_BUNDLE_SITES, STEP_SITES
from test_torch_norm_bwd_plan import SWIN_NORM_SITES, UNET_NORM_SITES  # every norm site of the two training steps
# every attention site of the float32 Swin step and of the bench SwinUNETR (head dim 8)
from test_torch_window_attention_bwd_plan import BENCH_ATTN_SITES, STEP_D8_SITES, SWIN_ATTN_SITES

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,ci,co", [
    ((2, 4, 8, 8), 32, 32),
    ((1, 3, 5, 7), 16, 24),
    ((1, 6, 6, 6), 64, 40),
    ((2, 5, 9, 4), 2, 2),
    ((1, 3, 4, 5), 1, 1),
    ((2, 4, 3, 6), 8, 4),
    ((1, 5, 5, 5), 4, 3),
    ((1, 3, 3, 3), 9, 4),
    ((1, 4, 4, 4), 3, 72),
    ((1, 2, 3, 5), 256, 128),
    ((2, 8, 9, 10), 1, 24),    # SwinUNETR's input conv: one input channel
    ((2, 3, 3, 3), 384, 384),  # SwinUNETR's bottleneck at 3^3
])
@pytest.mark.parametrize("with_bias", [False, True])
def test_conv_kernel_matches_plain(cuda, dtype, shape, ci, co, with_bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((*shape, ci), generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 3, 3, ci, co), generator=g, device=cuda) / (27 * ci) ** 0.5).to(dtype)
    b = torch.randn((co,), generator=g, device=cuda).to(dtype) if with_bias else None
    with torch.inference_mode():
        before = conv3d_3x3_same.launches
        got = conv3d_3x3_same(x, w, b)
        assert conv3d_3x3_same.launches == before + 1
        _assert_close(got, conv3d_3x3_same_plain(x, w, b), dtype)


# ragged spatial shapes no brick divides, N in {1, 3}, every CI and CO class of the kernel
CONV_GRID_SHAPES = [(1, 5, 7, 9), (3, 5, 7, 9), (1, 1, 1, 1), (3, 1, 1, 1), (1, 3, 96, 5), (3, 3, 96, 5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CONV_GRID_SHAPES)
@pytest.mark.parametrize("ci", [1, 2, 8, 24, 48, 384])
@pytest.mark.parametrize("co", [2, 8, 24, 48, 192, 256])
@pytest.mark.parametrize("with_bias", [False, True])
def test_conv_kernel_grid(cuda, dtype, shape, ci, co, with_bias):
    g = torch.Generator(device=cuda).manual_seed(ci * 1000 + co)
    x = torch.randn((*shape, ci), generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 3, 3, ci, co), generator=g, device=cuda) / (27 * ci) ** 0.5).to(dtype)
    b = torch.randn((co,), generator=g, device=cuda).to(dtype) if with_bias else None
    with torch.inference_mode():
        before = conv3d_3x3_same.launches
        got = conv3d_3x3_same(x, w, b)
        assert conv3d_3x3_same.launches == before + 1
        assert got.dtype == dtype and got.shape == (*shape, co)
        _assert_close(got, conv3d_3x3_same_plain(x, w, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci,co", [(24, 24), (64, 64), (1, 24)])
def test_conv_kernel_at_many_bricks(cuda, dtype, ci, co):
    """More bricks than the card holds blocks at once: resident weights at 24 -> 24,
    streamed at 64 -> 64, and the im2col kernel at 1 -> 24, whose blocks walk over
    several bricks and build their weight tile once."""
    g = torch.Generator(device=cuda).manual_seed(ci + co)
    x = torch.randn((2, 40, 48, 56, ci), generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 3, 3, ci, co), generator=g, device=cuda) / (27 * ci) ** 0.5).to(dtype)
    b = torch.randn((co,), generator=g, device=cuda).to(dtype)
    with torch.inference_mode():
        _assert_close(conv3d_3x3_same(x, w, b), conv3d_3x3_same_plain(x, w, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci,co", [(16, 16), (24, 24), (3, 24), (48, 8)])
def test_conv_kernel_unaligned_input(cuda, dtype, ci, co):
    """Contiguous views that are not 16-byte aligned (x, w and bias one element into their
    storage) take the element-wise loads; each view ends where its storage ends, so a read
    past it would fault or show."""
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (1, 4, 5, 6, ci)
    x = torch.randn(1 + torch.Size(shape).numel(), generator=g, device=cuda).to(dtype)[1:].view(shape)
    w = (torch.randn(1 + 27 * ci * co, generator=g, device=cuda) / (27 * ci) ** 0.5).to(dtype)[1:]
    w = w.view(3, 3, 3, ci, co)
    b = torch.randn(co + 1, generator=g, device=cuda).to(dtype)[1:]
    with torch.inference_mode():
        got = conv3d_3x3_same(x, w, b)
        torch.cuda.synchronize()
        _assert_close(got, conv3d_3x3_same_plain(x, w, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,spatial", [(1, (5, 6, 7)), (2, (9, 8, 7)), (3, (4, 4, 4)), (16, (6, 5, 4)),
                                       (100, (3, 4, 5)), (256, (6, 6, 6)), (8, (5, 6, 7)), (12, (6, 5, 4)),
                                       (24, (7, 6, 5)), (48, (4, 5, 6)), (384, (3, 3, 3))])
@pytest.mark.parametrize("affine,slope", [(False, None), (False, "one"), (True, "per_channel"), (True, "leaky"),
                                         (True, None)])
def test_norm_kernel_matches_plain(cuda, dtype, c, spatial, affine, slope):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn((3, c, *spatial), generator=g, device=cuda) * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    w = torch.rand((c,), generator=g, device=cuda).to(dtype) + 0.5 if affine else None
    b = torch.randn((c,), generator=g, device=cuda).to(dtype) if affine else None
    a = {None: None, "one": torch.full((1,), 0.25, device=cuda, dtype=dtype),
         "leaky": torch.full((1,), 0.01, device=cuda, dtype=dtype),  # SwinUNETR's LeakyReLU
         "per_channel": torch.rand((c,), generator=g, device=cuda).to(dtype)}[slope]
    with torch.inference_mode():
        before = instance_norm_prelu.launches
        got = instance_norm_prelu(x, w, b, a)
        assert instance_norm_prelu.launches == before + 1
        assert got.shape == x.shape and got.dtype == dtype
        _assert_close(got, instance_norm_prelu_plain(x, w, b, a), dtype)


def _norm_inputs(g, shape, dtype, device, affine=True, slope=True):
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    w = (torch.rand((c,), generator=g, device=device) + 0.5).to(dtype) if affine else None
    b = torch.randn((c,), generator=g, device=device).to(dtype) if affine else None
    a = torch.full((1,), 0.01, device=device, dtype=dtype) if slope else None
    return x, w, b, a


def _norm_plan(x):
    """The plan the wrapper launches for x (B, C, *spatial) on its card."""
    card, occupancy = _card(x.device.index or 0)
    return instance_norm_plan(x.shape[0], x.shape[1], x[0, 0].numel(), x.dtype, x.data_ptr() % 16 == 0, card,
                              occupancy)


# (shape, path, unit groups > 1): each path of the plan, forced by the shape
NORM_PATHS = [((2, 3, 9, 10, 11), "general", False), ((3, 7, 5, 6, 7), "general", False),
              ((2, 64, 12, 12, 12), "onchip", False), ((3, 96, 12, 12, 12), "onchip", False),
              ((2, 384, 3, 3, 3), "onchip", False), ((2, 24, 24, 24, 24), "persistent", False),
              ((2, 2, 40, 40, 40), "persistent", False), ((3, 24, 40, 40, 40), "persistent", False),
              ((4, 24, 96, 96, 96), "persistent", True), ((3, 24, 37, 41, 43), "persistent", False),
              ((2500, 3, 5, 6, 7), "general", True), ((1200, 8, 30, 30, 30), "persistent", True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,path,several", NORM_PATHS)
def test_norm_kernel_paths(cuda, dtype, shape, path, several):
    """Each path of the plan (the general one, one on-chip pass, the persistent grid with
    one and with several groups of units), S not a multiple of a vector or a block, more
    units than the grid has blocks; two calls give the same bits, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, w, b, a = _norm_inputs(g, shape, dtype, cuda)
    p = _norm_plan(x)
    assert p["path"] == path and (path == "onchip" or (p["unit_groups"] > 1) == several)
    with torch.inference_mode():
        before = instance_norm_prelu.launches
        got = instance_norm_prelu(x, w, b, a)
        again = instance_norm_prelu(x, w, b, a)
        torch.cuda.synchronize()
        assert instance_norm_prelu.launches == before + 2
        assert torch.equal(got, again)
        _assert_close(got, instance_norm_prelu_plain(x, w, b, a), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [2, 16, 24, 64])
def test_norm_kernel_unaligned_input(cuda, dtype, c):
    """A channels-last view one element into its storage (not 16-byte aligned) takes the
    general path and still agrees; the view ends where its storage ends."""
    g = torch.Generator(device=cuda).manual_seed(4)
    shape = (2, 5, 6, 7, c)
    x = (torch.randn(1 + torch.Size(shape).numel(), generator=g, device=cuda) * 2).to(dtype)[1:].view(shape)
    x = x.permute(0, 4, 1, 2, 3)
    assert x.data_ptr() % 16 != 0 and _norm_plan(x)["path"] == "general"
    w = (torch.rand((c,), generator=g, device=cuda) + 0.5).to(dtype)
    b = torch.randn((c,), generator=g, device=cuda).to(dtype)
    with torch.inference_mode():
        got = instance_norm_prelu(x, w, b)
        torch.cuda.synchronize()
        _assert_close(got, instance_norm_prelu_plain(x, w, b), dtype)


def test_norm_kernel_at_the_widest_swin_site(cuda):
    """One full (6, 24, 96^3) bfloat16 site with SwinUNETR's LeakyReLU, the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x, w, b, a = _norm_inputs(g, (6, 24, 96, 96, 96), torch.bfloat16, cuda)
    assert _norm_plan(x)["path"] == "persistent"
    with torch.inference_mode():
        got = instance_norm_prelu(x, w, b, a)
        again = instance_norm_prelu(x, w, b, a)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, instance_norm_prelu_plain(x, w, b, a), torch.bfloat16)


def test_norm_kernel_takes_float32_parameters_of_a_bfloat16_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    x, w, b, a = _norm_inputs(g, (2, 24, 9, 9, 9), torch.bfloat16, cuda)
    with torch.inference_mode():
        got = instance_norm_prelu(x, w.float(), b.float(), torch.full((24,), 0.2, device=cuda))
        ref = instance_norm_prelu_plain(x, w.float(), b.float(), torch.full((24,), 0.2, device=cuda))
        _assert_close(got, ref, torch.bfloat16)


def test_norm_kernel_2d_channels_last(cuda):
    x = torch.randn((2, 8, 10, 12), device=cuda).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        _assert_close(instance_norm_prelu(x), instance_norm_prelu_plain(x), torch.float32)


def test_norm_kernel_rejects_channel_first_memory(cuda):
    x = torch.randn((2, 4, 3, 3, 3), device=cuda)  # contiguous NCDHW, not channels-last
    with torch.inference_mode(), pytest.raises(ValueError):
        instance_norm_prelu(x)


def test_small_unet_on_card_matches_cpu(cuda):
    net = UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, generator=torch.Generator().manual_seed(0),
               device="cpu").eval()
    x = torch.rand((2, 1, 16, 16, 16), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_small_segresnet_on_card_matches_cpu(cuda):
    """A SegResNet (group norm, nearest upsampling) at an odd size: every 3x3x3 conv on kernel
    1, the rest as the CPU runs it."""
    net = SegResNet(3, init_filters=8, in_channels=2, out_channels=3, blocks_down=(1, 2, 2), blocks_up=(1, 1),
                    generator=torch.Generator().manual_seed(0), device="cpu").eval()
    x = torch.rand((1, 2, 20, 12, 28), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = net(x)
        before = conv3d_3x3_same.launches
        got = net.to(cuda)(x.to(cuda)).cpu()
        assert conv3d_3x3_same.launches == before + 15
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# (windows, mask rows or None): the tensor-core instance walks a block over the windows
# of one mask row (B / nW of them: 3, 1, 2, 6, 13) or, without a mask, over a run of
# windows (B: 12, 1, 7, 13, 96), split over blocks by the shape
WINDOW_GROUPS = [(12, 4), (12, None), (5, 5), (6, 3), (12, 2), (26, 2), (1, None), (7, None), (13, None),
                 (96, None)]


def _attention_inputs(g, b, h, n, d, nw, dtype, device):
    q, k, v = (torch.randn((b, h, n, d), generator=g, device=device).to(dtype) for _ in range(3))
    bias = torch.randn((h, n, n), generator=g, device=device) * 0.5
    mask = None if nw is None else (torch.rand((nw, n, n), generator=g, device=device) > 0.5).float() * -100.0
    return q, k, v, bias, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("n", [27, 64, 100, 125, 216, 343, 512])
@pytest.mark.parametrize("b,nw", WINDOW_GROUPS)
def test_window_attention_kernel_matches_plain(cuda, dtype, d, n, b, nw):
    """The tensor-core instances (float32's and the others'), at the gate, and the same
    bits from two calls."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, bias, mask = _attention_inputs(g, b, 3, n, d, nw, dtype, cuda)
    with torch.inference_mode():
        assert window_attention_plan(q, k, v, bias, mask)["instance"] == ("tf32x3" if dtype == torch.float32
                                                                          else "mma")
        before = fused_window_attention.launches
        got = fused_window_attention(q, k, v, bias, mask)
        assert fused_window_attention.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype
        _assert_close(got, fused_window_attention_plain(q, k, v, bias, mask), dtype)
        assert torch.equal(got, fused_window_attention(q, k, v, bias, mask))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [4, 12, 20, 64])
@pytest.mark.parametrize("n", [27, 343, 729])
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_kernel_takes_any_head_dim(cuda, dtype, d, n, with_mask):
    """Head dims and windows past the fast instances run the generic one."""
    g = torch.Generator(device=cuda).manual_seed(d * 1000 + n)
    b, h, nw = 4, 2, 2
    q, k, v = (torch.randn((b, h, n, d), generator=g, device=cuda).to(dtype) for _ in range(3))
    q = (q.float() * d ** -0.5).to(dtype)
    bias = torch.randn((h, n, n), generator=g, device=cuda) * 0.5
    mask = (torch.rand((nw, n, n), generator=g, device=cuda) > 0.5).float() * -100.0 if with_mask else None
    with torch.inference_mode():
        before = fused_window_attention.launches
        got = fused_window_attention(q, k, v, bias, mask)
        assert fused_window_attention.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype
        _assert_close(got, fused_window_attention_plain(q, k, v, bias, mask), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("n", [27, 125, 343])
@pytest.mark.parametrize("nw", [None, 2])
def test_window_attention_kernel_reads_nothing_past_its_inputs(cuda, dtype, d, n, nw):
    """q, k, v, bias and mask are the heads of buffers whose tails are NaN: a read past
    the last window's rows (a key row past N, a query row of the last tile) or past the
    bias and mask would reach the output."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    b, h = 6, 2
    args = _attention_inputs(g, b, h, n, d, nw, dtype, cuda)
    heads = []
    for t in args:
        if t is None:
            heads.append(None)
            continue
        buf = torch.full((t.shape[0] + 2, *t.shape[1:]), float("nan"), device=cuda, dtype=t.dtype)
        buf[:t.shape[0]] = t
        heads.append(buf[:t.shape[0]])
    with torch.inference_mode():
        got = fused_window_attention(*heads)
        assert torch.isfinite(got.float()).all()
        _assert_close(got, fused_window_attention_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("n", [64, 343])
def test_window_attention_kernel_rows_masked_everywhere(cuda, dtype, d, n):
    """Rows whose every key is masked at -100 (the shifted-window masks' value): the
    softmax of a row that is -100 everywhere plus the bias is that of the bias alone."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, bias, mask = _attention_inputs(g, 8, 2, n, d, 4, dtype, cuda)
    mask[:, ::3] = -100.0  # every third query row of every mask row: all its keys
    mask[1] = -100.0       # and one whole mask row
    with torch.inference_mode():
        got = fused_window_attention(q, k, v, bias, mask)
        assert torch.isfinite(got.float()).all()
        _assert_close(got, fused_window_attention_plain(q, k, v, bias, mask), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16, 32])
def test_window_attention_kernel_unaligned_inputs_take_the_fma_instance(cuda, dtype, d):
    """q, k and v that start one element past a 16-byte boundary cannot be copied by
    cp.async: such a launch runs the FMA instance, and agrees with the plain version."""
    g = torch.Generator(device=cuda).manual_seed(11)
    args = _attention_inputs(g, 6, 3, 125, d, 3, dtype, cuda)
    moved = []
    for t in args[:3]:
        flat = torch.empty(t.numel() + 1, device=cuda, dtype=dtype)
        flat[1:] = t.flatten()
        moved.append(flat[1:].view(t.shape))
    with torch.inference_mode():
        assert window_attention_plan(*moved, *args[3:])["instance"] == "fma"
        assert window_attention_plan(*args)["instance"] == ("tf32x3" if dtype == torch.float32 else "mma")
        _assert_close(fused_window_attention(*moved, *args[3:]), fused_window_attention_plain(*args), dtype)


@pytest.mark.parametrize("b,h,n,d,nw,instance", [
    (2058, 3, 343, 8, 343, "mma"), (2058, 3, 343, 8, None, "mma"), (384, 6, 343, 8, 64, "mma"),
    (48, 12, 343, 8, None, "mma"), (6, 24, 216, 8, None, "mma"), (2058, 6, 343, 16, 343, "mma"),
    (96, 3, 729, 12, 8, "generic"), (12, 3, 343, 4, None, "generic"),
    # the float32 step's sites and their head-dim-8 twins; a few shapes the card tests give
    *[(*site, "mma") for site in list(SWIN_ATTN_SITES) + STEP_D8_SITES],
    (12, 3, 512, 32, 4, "mma"), (12, 3, 343, 32, None, "mma"), (5, 3, 27, 8, 5, "mma"), (96, 3, 100, 16, None, "mma"),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_plan_at_the_swin_sites(cuda, b, h, n, d, nw, instance, dtype):
    """The Swin sites run the tensor-core instances (bfloat16 and float16 "mma", float32
    "tf32x3"), with at least one block an SM and the windows of a mask row split so that
    every window is covered once; float32's plan is the one ``attention_fwd_plan`` makes
    on the host from the card's SMs and blocks an SM."""
    q = torch.zeros((b, h, n, d), device=cuda, dtype=dtype)
    bias = torch.zeros((h, n, n), device=cuda)
    mask = None if nw is None else torch.zeros((nw, n, n), device=cuda)
    plan = window_attention_plan(q, q, q, bias, mask)
    expected = "tf32x3" if dtype == torch.float32 and instance == "mma" else instance
    assert plan["instance"] == expected
    if expected in ("mma", "tf32x3"):
        per_row = b // (nw or 1)
        splits = -(-per_row // plan["windows_per_block"])
        assert plan["blocks"] == -(-n // plan["rows_per_block"]) * h * (nw or 1) * splits
        assert plan["blocks_per_sm"] >= 1 and 0 < plan["smem_bytes"] <= 232448
    if expected == "tf32x3":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        host = attention_fwd_plan(b, h, n, d, nw or 0, sms, plan["blocks_per_sm"])
        assert {key: host[key] for key in plan} == plan


def test_window_attention_kernel_rejects_a_head_dim_past_shared_memory(cuda):
    """At D = 512 the generic instance's key chunks need more shared memory than a block
    may have: the kernel refuses, the wrapper raises and counts no launch."""
    q = torch.zeros((2, 1, 27, 512), device=cuda)
    before = fused_window_attention.launches
    with torch.inference_mode(), pytest.raises(RuntimeError, match="launch failed"):
        fused_window_attention(q, q, q, torch.zeros((1, 27, 27), device=cuda))
    assert fused_window_attention.launches == before


@pytest.mark.parametrize("feature_size", [24, 12])
def test_small_swin_unetr_on_card_matches_cpu(cuda, feature_size):
    net = SwinUNETR(1, 3, feature_size=feature_size, generator=torch.Generator().manual_seed(0),
                    device="cpu").eval()
    x = torch.rand((2, 1, 32, 32, 32), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("name", ["unet", "swinunetr"])
def test_small_nets_in_float16_on_card_run_the_float16_kernels(cuda, name):
    """``.to(torch.float16)`` on the card: every kernel of the net launches its float16
    instance, and the logits agree with the CPU float32 forward to 2^-10 x depth of max."""
    g = torch.Generator().manual_seed(0)
    if name == "unet":
        net, depth, kernels = UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, generator=g, device="cpu"), 17, 2
        x = torch.rand((2, 1, 16, 16, 16), generator=torch.Generator().manual_seed(1))
    else:
        net, depth, kernels = SwinUNETR(1, 3, feature_size=12, generator=g, device="cpu"), 40, 3
        x = torch.rand((1, 1, 32, 32, 32), generator=torch.Generator().manual_seed(1))
    wrappers = (conv3d_3x3_same, instance_norm_prelu, fused_window_attention)[:kernels]
    with torch.inference_mode():
        ref = net.eval()(x)
        before = [f.launches for f in wrappers]
        got = net.to(cuda, torch.float16)(x.to(cuda, torch.float16))
        assert got.dtype == torch.float16
        assert all(f.launches > b for f, b in zip(wrappers, before))
    assert (got.float().cpu() - ref).abs().max().item() <= 2.0 ** -10 * depth * ref.abs().max().item()


def _diag(scales, offsets):
    m = np.diag([*scales, 1.0])
    m[:3, 3] = offsets
    return m


RESAMPLE_CASES = [
    ((2, 13, 17, 11), _diag([0.45, 0.7, 0.38], [0.3, -0.6, 0.1]), (29, 24, 27)),   # upsampling
    ((1, 31, 27, 33), _diag([2.9, 2.3, 1.9], [-0.4, 0.5, 0.2]), (11, 13, 17)),     # downsampling
    ((3, 1, 19, 21), _diag([1.0, 0.55, 1.7], [0.0, 0.25, -1.5]), (1, 35, 13)),     # a 2-D image as depth 1
    ((1, 9, 10, 11), _diag([1.0, 1.0, 1.0], [0.0, 0.0, 0.0]), (9, 10, 11)),        # every axis the identity
    ((1, 12, 14, 16), _diag([1.25, 1.0, -1.0], [-2.0, 0.0, 15.0]), (9, 14, 16)),   # one axis resampled, one flipped
    ((3, 9, 23, 100), _diag([0.45, 0.7, 0.33], [0.3, -0.2, 0.1]), (19, 33, 300)),  # C = 3, tiles straddling every edge
    ((1, 20, 21, 22), _diag([0.9, 1.1, 0.8], [-6.0, 5.0, -9.0]), (37, 45, 70)),    # rows wholly outside the input
    ((1, 5, 5, 16000), _diag([2.0, 2.0, 800.0], [0.1, 0.2, 3.0]), (2, 2, 20)),     # 800x along x: the axes route
]
RESAMPLE_ROUTES = ["fused"] * 7 + ["axes"]


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("bound", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("case", range(len(RESAMPLE_CASES)))
def test_separable_resample_kernel_matches_plain(cuda, order, bound, align_corners, case):
    """Every case, order, bound and align_corners on the route the plan gives: the fused
    one in one CUDA launch (as the C function counts them), the axes one in one a
    resampled axis; the tiles of the C = 3 case straddle the output's edge on every axis."""
    shape, m, out_shape = RESAMPLE_CASES[case]
    plan = resample_plan(shape, out_shape, m, order, bound, align_corners)
    assert plan.route == RESAMPLE_ROUTES[case]
    assert plan.launches == (1 if plan.route == "fused" else sum(not i for i in plan.identity))
    if shape == (3, 9, 23, 100):
        assert all(n > t and n % t for n, t in zip(out_shape, plan.tile))
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(case), device=cuda)
    with torch.inference_mode():
        before, cuda_before = separable_resample_3d.launches, separable_resample_3d.cuda_launches
        got = separable_resample_3d(x, m, out_shape, order, bound, align_corners)
        assert separable_resample_3d.launches == before + 1
        assert separable_resample_3d.cuda_launches == cuda_before + plan.launches
        ref = separable_resample_3d_plain(x, m, out_shape, order, bound, align_corners)
    assert got.shape == ref.shape == (shape[0], *out_shape) and got.dtype == torch.float32
    if order == 0:
        assert torch.equal(got, ref)
    else:
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("site", ["spacing", "inverse"])
def test_separable_resample_kernel_at_the_spleen_sites(cuda, site):
    m = _diag([1.5 / 0.79, 1.5 / 0.79, 0.4], [0.0, 0.0, 0.0])
    g = torch.Generator(device=cuda).manual_seed(7)
    if site == "spacing":
        x, mat, out, order = torch.randn((1, 512, 512, 90), generator=g, device=cuda) * 300, m, (270, 270, 224), 1
    else:
        x = (torch.rand((1, 270, 270, 224), generator=g, device=cuda) > 0.5).float()
        mat, out, order = np.linalg.inv(m), (512, 512, 90), 0
    with torch.inference_mode():
        got = separable_resample_3d(x, mat, out, order, "border")
        ref = separable_resample_3d_plain(x, mat, out, order, "border")
    if order == 0:
        assert torch.equal(got, ref)
    else:
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("size", range(57, 71))
def test_separable_resample_kernel_at_the_mednist_zoom_sites(cuda, size):
    """The MedNIST bundle's RandZoomd on a 64x64 image (z in [0.9, 1.1]): a depth-1 volume
    (1, 1, 64, 64) resampled to (1, 1, size, size) at order 1, border, the half-pixel map of
    Zoom, against the plain version (1e-5) and ``F.interpolate(mode="bilinear",
    align_corners=False)``, which computes the same map (1e-5)."""
    m = _diag([1.0, 64 / size, 64 / size], [0.0, (64 / size - 1) / 2, (64 / size - 1) / 2])
    x = torch.rand((1, 1, 64, 64), generator=torch.Generator(device=cuda).manual_seed(size), device=cuda)
    with torch.inference_mode():
        before = separable_resample_3d.launches
        got = separable_resample_3d(x, m, (1, size, size), 1, "border")
        assert separable_resample_3d.launches == before + 1
        ref = separable_resample_3d_plain(x, m, (1, size, size), 1, "border")
        lib = torch.nn.functional.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
    assert got.shape == ref.shape == lib.shape == (1, 1, size, size)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (lib - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_mednist_zoom_runs_kernel_3_on_the_card(cuda):
    """RandZoomd on a CUDA image launches kernel 3 once a draw that resizes, and matches
    the same draw on the CPU (1e-5)."""
    from monai_tpu_torch.data import MetaImage
    from monai_tpu_torch.transforms import RandZoomd

    x = torch.rand((1, 64, 64), generator=torch.Generator().manual_seed(3))
    for seed in range(6):
        outs, launched = [], 0
        for device in (cuda, "cpu"):
            t = RandZoomd(keys="image", min_zoom=0.9, max_zoom=1.1, prob=1.0).set_random_state(seed)
            before = separable_resample_3d.launches
            outs.append(t({"image": MetaImage(x.to(device))})["image"].data.cpu())
            launched += separable_resample_3d.launches - before
        assert launched == int(int(64 * t.t._zoom[0]) != 64)
        assert (outs[0] - outs[1]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("order", range(8))
def test_grid_pull_and_push_on_the_card_match_the_cpu(cuda, order):
    """The general resample's pull at every bound, and its push and count, on the card
    against the CPU's float64 on the same float32 inputs: order 0 bit-identical to the CPU's
    float32 pull, else 1e-5 of max|ref| (float32 sums of up to 8^3 taps; the push's
    scatter-add in no fixed order)."""
    from monai_tpu_torch.ops import resample as R

    g = torch.Generator().manual_seed(order)
    x = torch.randn((3, 20, 18, 16), generator=g)
    a = np.eye(4)
    a[:3, :3] = [[0.9, -0.3, 0.1], [0.35, 0.85, -0.2], [0.05, 0.25, 1.1]]
    a[:3, 3] = [-2.0, 3.0, -1.5]
    grid = R.affine_grid(a, (14, 15, 13)).float()
    y = torch.randn((3, 14, 15, 13), generator=g)
    for bound in ("zeros", "border", "reflection", "dct1", "dst1", "dst2", "dft", "sliding"):
        got = R.grid_pull(x.to(cuda), grid.to(cuda), order, bound).cpu()
        if order == 0:
            assert torch.equal(got, R.grid_pull(x, grid, order, bound)), bound
        else:
            ref = R.grid_pull(x.double(), grid.double(), order, bound)
            assert (got.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), bound
        push = R.grid_push(y.to(cuda), grid.to(cuda), x.shape[1:], order, bound).cpu()
        ref = R.grid_push(y.double(), grid.double(), x.shape[1:], order, bound)
        assert (push.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), bound
        count = R.grid_count(grid.to(cuda), x.shape[1:], order, bound).cpu()
        ref = R.grid_count(grid.double(), x.shape[1:], order, bound)
        assert (count.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), bound


def test_separable_resample_kernel_rejects_other_types(cuda):
    with torch.inference_mode(), pytest.raises(TypeError):
        separable_resample_3d(torch.zeros((1, 4, 4, 4), device=cuda, dtype=torch.bfloat16), np.eye(4), (4, 4, 4))


def test_spleen_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """The bundle's preprocessing on the card equals the CPU's (to 1e-5), the batch-norm
    UNet's logits agree (1e-4 of max), and the inverse of one label map is identical."""
    from monai_tpu_torch.data import write_nifti
    from monai_tpu_torch.inferers import SlidingWindowInferer
    from monai_tpu_torch.transforms import (Compose, EnsureChannelFirstd, Invertd, LoadImaged, Orientationd,
                                            ScaleIntensityRanged, Spacingd)

    vol = (np.random.RandomState(0).rand(64, 64, 20) * 1200 - 1000).astype(np.int16)
    path = str(tmp_path / "ct.nii.gz")
    write_nifti(vol, path, affine=np.diag([-0.79, -0.79, 5.0, 1.0]))

    def pre(device):
        return Compose([LoadImaged("image", device=device), EnsureChannelFirstd("image"),
                        Orientationd("image", axcodes="RAS"), Spacingd("image", pixdim=[1.5, 1.5, 2.0]),
                        ScaleIntensityRanged("image", a_min=-57, a_max=164, b_min=0.0, b_max=1.0, clip=True)])

    card, cpu = pre(None), pre("cpu")
    with torch.inference_mode():
        before = separable_resample_3d.launches
        d = card({"image": path})
        assert separable_resample_3d.launches == before + 1 and d["image"].data.is_cuda
        d_cpu = cpu({"image": path})
        assert (d["image"].data.cpu() - d_cpu["image"].data).abs().max().item() <= 1e-5
        net = UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, norm="batch",
                   generator=torch.Generator().manual_seed(0), device="cpu").eval()
        ref = SlidingWindowInferer(32, 4, 0.25)(d_cpu["image"].data[None], net)
        got = SlidingWindowInferer(32, 4, 0.25)(d["image"].data[None], net.to(cuda)).cpu()
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
        labels = got[0].argmax(0, keepdim=True).float()
        inv = Invertd("pred", transform=card, orig_keys="image")
        on_card = inv({"image": d["image"], "pred": labels.to(cuda)})["pred"]
        on_cpu = inv({"image": d["image"], "pred": labels})["pred"]
    assert on_card.data.is_cuda and on_card.shape == (1, 64, 64, 20)
    assert torch.equal(on_card.data.cpu(), on_cpu.data)


def _bilateral_check(x, ss, cs, tol=1e-5):
    with torch.inference_mode():
        before = bilateral_stencil.launches
        got = bilateral_stencil(x, ss, cs)
        assert bilateral_stencil.launches == before + 1
        ref = bilateral_stencil_plain(x, ss, cs)
    assert got.shape == x.shape and got.dtype == x.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# spatial sigma r / 2 gives radius r at truncate 2
@pytest.mark.parametrize("radius", range(1, 9))
@pytest.mark.parametrize("shape", [(1, 1, 37, 100), (3, 1, 5, 7), (1, 3, 61, 33), (90, 1, 24, 40)])
def test_bilateral_2d_kernel_matches_plain(cuda, radius, shape):
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(radius), device=cuda)
    _bilateral_check(x, radius / 2, 0.3)


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("shape", [(1, 1, 9, 20, 100), (1, 3, 7, 5, 9), (2, 1, 3, 2, 4), (3, 30, 5, 6, 7)])
def test_bilateral_3d_kernel_matches_plain(cuda, radius, shape):
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(radius), device=cuda)
    _bilateral_check(x, radius / 2, 0.3)


@pytest.mark.parametrize("shape,radius", [((1, 1, 30, 70), 46), ((1, 1, 9, 11, 13), 6)])
def test_bilateral_kernel_reads_global_memory_beyond_the_shared_budget(cuda, shape, radius):
    """A halo tile above 48 KB: the taps come from global memory."""
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    _bilateral_check(x, radius / 2, 0.3)


@pytest.mark.parametrize("dtype,step", [(torch.bfloat16, 2.0 ** -8), (torch.float16, 2.0 ** -11)])
@pytest.mark.parametrize("shape", [(2, 1, 33, 47), (1, 2, 6, 17, 21)])
def test_bilateral_kernel_casts_other_types(cuda, dtype, step, shape):
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda).to(dtype)
    with torch.inference_mode():
        got = bilateral_stencil(x, 1.0, 0.2)
        ref = bilateral_stencil_plain(x.float(), 1.0, 0.2)
    assert got.dtype == dtype
    assert (got.float() - ref).abs().max().item() <= step * ref.abs().max().item()


def test_bilateral_kernel_takes_a_non_contiguous_input(cuda):
    base = torch.rand((2, 1, 5, 40, 33), generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    x = base.transpose(-1, -2)
    assert not x.is_contiguous()
    _bilateral_check(x, 1.0, 0.3)
    _bilateral_check(base[:, :, ::2, :, 1:], 1.0, 0.3)


@pytest.mark.parametrize("cs", [0.01, 10.0])
@pytest.mark.parametrize("shape", [(2, 1, 33, 47), (1, 1, 6, 17, 21)])
def test_bilateral_kernel_color_sigma_extremes(cuda, cs, shape):
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    _bilateral_check(x, 1.5 if len(shape) == 4 else 1.0, cs)


@pytest.mark.parametrize("shape", [(1, 1, 30, 31), (1, 1, 7, 9, 11)])
def test_bilateral_kernel_keeps_a_constant_image(cuda, shape):
    x = torch.full(shape, 3.7, device=cuda)
    with torch.inference_mode():
        got = bilateral_stencil(x, 1.0, 0.3)
    assert (got - 3.7).abs().max().item() <= 1e-6 * 3.7


def test_bilateral_filter_reaches_the_kernel(cuda):
    for shape in [(1, 1, 20, 30), (1, 1, 6, 20, 30)]:
        x = torch.rand(shape, device=cuda)
        with torch.inference_mode():
            before = bilateral_stencil.launches
            got = bilateral_filter(x, 1.0, 0.3)
            assert bilateral_stencil.launches == before + 1
            ref = bilateral_stencil_plain(x, 1.0, 0.3)
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _pair_edge_shapes(sd, r):
    """Shapes where a pair kernel meets its edges (pure Python, from ``bilateral_plan``):
    sizes <= r; the columns one past a warp's and one past a block's; the rows one past a
    block's (3-D); the walked axis cut into segments, the last one short; several planes."""
    ox = bilateral_plan((1, 1, 1, 1, 1)[: sd + 2], r)["cols_per_warp"]

    def past_a_segment(shape):  # the walked axis (D in 3-D, H in 2-D): segments, the last one short
        for n in range(8 * r + 1, 40 * r):
            plan = bilateral_plan(shape[:2] + (n,) + shape[3:], r)
            if plan["tiles"][2] > 1 and n % plan["seg"]:
                return shape[:2] + (n,) + shape[3:]
        return shape[:2] + (8 * r + 1,) + shape[3:]

    if sd == 2:
        return [(1, 1, r, r), (2, 3, 1, r), past_a_segment((1, 1, 0, ox + 1)), (3, 1, 5, 4 * ox + 1)]
    wy = bilateral_plan((1, 1, 1, 1, ox + 1), r)["warps_y"]
    return [(1, 1, r, r, r), (2, 3, 1, r, 2), past_a_segment((1, 1, 0, 8 * wy + 1, ox + 1)),
            (2, 1, 3, 9, 4 * ox + 1)]


PAIR_EDGE_CASES = [(sd, r, shape) for sd in (2, 3) for r in range(1, PAIR_RADIUS[sd] + 1)
                   for shape in _pair_edge_shapes(sd, r)]


@pytest.mark.parametrize("sd,radius,shape", PAIR_EDGE_CASES)
def test_bilateral_pair_kernel_at_its_edges(cuda, sd, radius, shape):
    """Each radius's pair kernel where the pair sharing meets the clamped halo and the
    threads past the image: sizes <= r, one past a warp and a block, a short last
    segment, several planes."""
    assert bilateral_plan(shape, radius)["instance"] == "pair"
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(radius), device=cuda)
    _bilateral_check(x, radius / 2, 0.3)


@pytest.mark.parametrize("shape,radius", [((1, 1, 40, 60, 70), 2), ((3, 1, 100, 130), 5), ((1, 1, 9, 20, 30), 4),
                                          ((2, 1, 40, 50), 9), ((1, 1, 30, 70), 46)])
def test_bilateral_kernel_gives_the_same_bits_twice(cuda, shape, radius):
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(11), device=cuda)
    with torch.inference_mode():
        first, again = bilateral_stencil(x, radius / 2, 0.2), bilateral_stencil(x, radius / 2, 0.2)
    assert torch.equal(first, again)


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_bilateral_3d_pair_kernel_with_four_warps_across(cuda, radius):
    """The 3-D pair kernel with its four warps side by side (the layout of stage A), at a
    width of four warps' columns, two planes and a row one past a block's."""
    shape = (2, 1, 9, 9, 4 * (32 - 2 * radius))
    assert bilateral_plan(shape, radius)["warps_x"] == 4
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(radius), device=cuda)
    _bilateral_check(x, radius / 2, 0.3)


EXPS_CASES = ([(shape, r, None) for sd, r, shape in PAIR_EDGE_CASES]
              + [((2, 1, 9, 9, 4 * (32 - 2 * r)), r, None) for r in (1, 2, 3)]
              + [((3, 1, 100, 130), 5, 7), ((1, 1, 40, 60, 70), 2, 100)]
              + [((2, 1, 40, 50), 9, None), ((1, 1, 30, 70), 46, None), ((1, 1, 9, 20, 30), 4, None),
                 ((1, 1, 7, 12, 40), 6, None)])


@pytest.mark.parametrize("shape,radius,seg", EXPS_CASES)
def test_bilateral_kernel_computes_the_plans_exps(cuda, shape, radius, seg):
    """The checked build of each instance counts the exps its threads compute: exactly the
    plan's count, on the card's SM count (and a forced segment length), with the same
    output as the plain version."""
    x = torch.rand(shape, generator=torch.Generator(device=cuda).manual_seed(radius), device=cuda)
    plan = bilateral_plan(shape, radius, torch.cuda.get_device_properties(cuda).multi_processor_count, seg)
    with torch.inference_mode():
        got, exps = bilateral_exps(x, radius / 2, 0.3, seg=seg)
        ref = bilateral_stencil_plain(x, radius / 2, 0.3)
    assert exps == plan["exps"], (plan["label"], exps, plan["exps"])
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("sd,radius,warps_x", [(2, r, 1) for r in range(1, 9)]
                         + [(3, r, wx) for r in range(1, 4) for wx in (1, 2, 4)])
def test_bilateral_pair_residency_is_the_plans(cuda, sd, radius, warps_x):
    """The blocks an SM holds that the plan sizes the segments with are those the CUDA
    runtime works out for the built instance."""
    assert card_resident(cuda, sd, radius, warps_x) == PAIR_RESIDENT[sd][radius]


# ---- the backward kernels: the conv's dw and dx, the norm's backward ----

# ragged spatial shapes that no brick divides, N in {1, 2}
WGRAD_SHAPES = [(1, 5, 6, 7), (2, 3, 9, 4)]


def _wgrad_inputs(g, shape, ci, co, dtype, device):
    x = torch.randn((*shape, ci), generator=g, device=device).to(dtype)
    gy = torch.randn((*shape, co), generator=g, device=device).to(dtype)
    return x, gy


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", WGRAD_SHAPES)
@pytest.mark.parametrize("ci", [1, 2, 8, 16, 48, 256])
@pytest.mark.parametrize("co", [2, 8, 16, 256])
def test_conv_wgrad_kernel_grid(cuda, dtype, shape, ci, co):
    """Every CI and CO class of the weight-gradient kernel: the tensor-core route where
    both are multiples of 8 in bfloat16 and float16, the small route where both are 1 or
    2, the FMA route (register tiles of 1, 2 or 4 by 2 or 8 channels) elsewhere."""
    g = torch.Generator(device=cuda).manual_seed(ci * 1000 + co)
    x, gy = _wgrad_inputs(g, shape, ci, co, dtype, cuda)
    plan = conv3d_3x3_wgrad_plan(x, gy)
    assert plan["route"] == ("mma" if dtype != torch.float32 and ci % 8 == 0 and co % 8 == 0 else
                             "small" if ci <= 2 and co <= 2 else "fma")
    before = conv3d_3x3_wgrad.launches
    got = conv3d_3x3_wgrad(x, gy)
    assert conv3d_3x3_wgrad.launches == before + 1
    assert got.dtype == dtype and got.shape == (3, 3, 3, ci, co)
    _assert_close(got, conv3d_3x3_wgrad_plain(x, gy), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci,co", [(16, 16), (2, 2), (32, 32)])
def test_conv_wgrad_kernel_at_many_bricks(cuda, dtype, ci, co):
    """K far longer than one chunk (2 x 40 x 48 x 56 voxels): each block walks over many
    bricks, and the chunks' partials add up in order; the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(ci + co)
    x, gy = _wgrad_inputs(g, (2, 40, 48, 56), ci, co, dtype, cuda)
    got = conv3d_3x3_wgrad(x, gy)
    again = conv3d_3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert conv3d_3x3_wgrad_plan(x, gy)["chunks"] > 1
    _assert_close(got, conv3d_3x3_wgrad_plain(x, gy), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci,co", [(1, 48), (48, 48), (96, 48), (192, 96), (768, 768)])
def test_conv_wgrad_kernel_at_the_swin_channels(cuda, dtype, ci, co):
    """The float32 SwinUNETR step's channel classes (its 1 -> 48 input conv, the 48- to
    768-channel layers) at a ragged shape that no brick divides (lines of 37 split into 19
    and 18), in all three types, with several chunks where the tiles leave room."""
    g = torch.Generator(device=cuda).manual_seed(ci + 7 * co)
    shape = (1, 5, 3, 37) if ci * co > 10000 else (2, 9, 7, 37)
    x, gy = _wgrad_inputs(g, shape, ci, co, dtype, cuda)
    got = conv3d_3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3, 3, 3, ci, co)
    _assert_close(got, conv3d_3x3_wgrad_plain(x, gy), dtype)


def test_conv_wgrad_kernel_float32_gives_the_same_bits_twice(cuda):
    """Float32 96 -> 48 over 2 x 40 x 48 x 96 voxels: the FMA route over many chunks of many
    bricks, their partials added in a fixed order."""
    g = torch.Generator(device=cuda).manual_seed(96)
    x, gy = _wgrad_inputs(g, (2, 40, 48, 96), 96, 48, torch.float32, cuda)
    plan = conv3d_3x3_wgrad_plan(x, gy)
    assert plan["route"] == "fma" and plan["chunks"] > 8 and plan["per_chunk"] > 4
    got = conv3d_3x3_wgrad(x, gy)
    again = conv3d_3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, conv3d_3x3_wgrad_plain(x, gy), torch.float32)


@pytest.mark.parametrize("dtype,ci,co,spatial", STEP_SITES)
def test_conv_wgrad_host_plan_is_the_cards(cuda, dtype, ci, co, spatial):
    """``wgrad_plan`` on the host, given the card's SM count and the blocks an SM holds as
    the card's plan says, is the card's own plan at every site of both training steps
    (batch 4), and for unaligned inputs at the same shapes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for offset in (0, 1):
        x = torch.empty(4 * math.prod(spatial) * ci + offset, dtype=dtype, device=cuda)[offset:].view(4, *spatial, ci)
        gy = torch.empty(4 * math.prod(spatial) * co + offset, dtype=dtype, device=cuda)[offset:].view(4, *spatial, co)
        card = conv3d_3x3_wgrad_plan(x, gy)
        assert card == wgrad_plan(x.shape, co, dtype, offset == 0, sms, card["per_sm"]), offset


@pytest.mark.parametrize("batch,ci,co,spatial", sorted(F32_BUNDLE_SITES))
def test_conv_kernels_at_the_float32_bundle_sites(cuda, batch, ci, co, spatial):
    """Kernel 1's forward, its dx and the dw kernel in float32 at each site of the BraTS
    bundle's SegResNet step (batch 1; its 1 -> 16 input conv included) and of the Spleen
    bundle's batch-norm UNet step (batch 8), through autograd of the wrapper: three launches,
    each result against autograd of the plain version; and the host's dw plan is the card's."""
    g = torch.Generator(device=cuda).manual_seed(ci * 31 + co)
    x = torch.randn((batch, *spatial, ci), generator=g, device=cuda).requires_grad_()
    w = (torch.randn((3, 3, 3, ci, co), generator=g, device=cuda) / (27 * ci) ** 0.5).requires_grad_()
    gy = torch.randn((batch, *spatial, co), generator=g, device=cuda)
    before = conv3d_3x3_same.launches, conv3d_3x3_wgrad.launches
    y = conv3d_3x3_same(x, w)
    got = (y, *torch.autograd.grad(y, (x, w), gy))
    assert (conv3d_3x3_same.launches, conv3d_3x3_wgrad.launches) == (before[0] + 2, before[1] + 1)
    y = conv3d_3x3_same_plain(x, w)
    ref = (y, *torch.autograd.grad(y, (x, w), gy))
    for a, r in zip(got, ref):
        _assert_close(a, r, torch.float32)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    card = conv3d_3x3_wgrad_plan(x.detach(), gy)
    assert card == wgrad_plan(x.shape, co, torch.float32, True, sms, card["per_sm"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci,co", [(16, 16), (8, 2), (48, 8)])
def test_conv_wgrad_kernel_unaligned_inputs(cuda, dtype, ci, co):
    """x and g one element into their storage (not 16-byte aligned) take the FMA route;
    each view ends where its storage ends."""
    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (1, 4, 5, 6)
    x = torch.randn(1 + 120 * ci, generator=g, device=cuda).to(dtype)[1:].view(*shape, ci)
    gy = torch.randn(1 + 120 * co, generator=g, device=cuda).to(dtype)[1:].view(*shape, co)
    assert conv3d_3x3_wgrad_plan(x, gy)["route"] == "fma"
    got = conv3d_3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    _assert_close(got, conv3d_3x3_wgrad_plain(x, gy), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci", [1, 2, 8, 16, 48, 256])
@pytest.mark.parametrize("co", [2, 8, 16, 256])
def test_conv_backward_on_the_kernels(cuda, dtype, ci, co):
    """Autograd through the wrapper over the grid of CI and CO: dx on the forward kernel
    (one more launch, at CO -> CI), dw on the weight-gradient kernel, db a float32 sum;
    against autograd of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(ci * 7 + co)
    shape = (2, 5, 6, 7)
    x = torch.randn((*shape, ci), generator=g, device=cuda).to(dtype).requires_grad_()
    w = (torch.randn((3, 3, 3, ci, co), generator=g, device=cuda) / (27 * ci) ** 0.5).to(dtype).requires_grad_()
    b = torch.randn((co,), generator=g, device=cuda).to(dtype).requires_grad_()
    gy = torch.randn((*shape, co), generator=g, device=cuda).to(dtype)
    params = [x, w, b]
    before = conv3d_3x3_same.launches, conv3d_3x3_wgrad.launches
    got = torch.autograd.grad(conv3d_3x3_same(x, w, b), params, gy)
    assert (conv3d_3x3_same.launches, conv3d_3x3_wgrad.launches) == (before[0] + 2, before[1] + 1)
    ref = torch.autograd.grad(conv3d_3x3_same_plain(x, w, b), params, gy)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == dtype
        _assert_close(a, r, dtype)


def _norm_bwd_inputs(g, shape, dtype, device, affine, slope, gamma=None):
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    fmt = torch.channels_last_3d if len(shape) == 5 else torch.channels_last
    x = x.contiguous(memory_format=fmt)
    gy = torch.randn(shape, generator=g, device=device).to(dtype).contiguous(memory_format=fmt)
    w = b = a = None
    if affine:
        w = (torch.rand((c,), generator=g, device=device) + 0.5).to(dtype) if gamma is None else \
            torch.full((c,), gamma, device=device).to(dtype)
        b = torch.randn((c,), generator=g, device=device).to(dtype)
    if slope == "one":
        a = torch.full((1,), 0.25, device=device).to(dtype)
    elif slope == "per_channel":
        a = torch.rand((c,), generator=g, device=device).to(dtype)
    return x, gy, w, b, a


def _norm_bwd_check(x, gy, w, b, a, dtype):
    with torch.inference_mode():
        _, stats = _forward(x, w, b, a, 1e-5, True)
        before = instance_norm_prelu_backward.launches
        dx, sums = instance_norm_prelu_backward(gy, x, stats, w, b, a)
        assert instance_norm_prelu_backward.launches == before + 1
        again = instance_norm_prelu_backward(gy, x, stats, w, b, a)
        torch.cuda.synchronize()
        assert torch.equal(dx, again[0]) and torch.equal(sums, again[1])
        ref_dx, ref_sums = instance_norm_prelu_backward_plain(gy, x, stats, w, b, a)
    assert dx.dtype == dtype and dx.shape == x.shape
    _assert_close(dx, ref_dx, dtype)
    for s, r in zip(sums, ref_sums):  # float32 sums of float32 terms in another order
        if r.abs().max().item() > 0:
            _assert_close(s, r, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 1, 5, 6, 7), (2, 2, 9, 8, 7), (1, 3, 4, 4, 4), (3, 16, 6, 5, 4),
                                   (2, 24, 7, 7, 7), (2, 64, 6, 6, 6), (1, 256, 3, 3, 3), (2, 8, 10, 12)])
@pytest.mark.parametrize("affine,slope", [(False, None), (False, "one"), (True, "per_channel"), (True, "one")])
def test_norm_backward_kernel_matches_plain(cuda, dtype, shape, affine, slope):
    g = torch.Generator(device=cuda).manual_seed(shape[1] * 31 + len(shape))
    x, gy, w, b, a = _norm_bwd_inputs(g, shape, dtype, cuda, affine, slope)
    _norm_bwd_check(x, gy, w, b, a, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 2, 48, 48, 48), (4, 16, 24, 24, 24), (2, 32, 20, 20, 20)])
def test_norm_backward_kernel_split_path(cuda, dtype, shape):
    """Instances that no block holds: the persistent grid, several blocks an instance whose
    partials are added in order after the grid barrier, in one launch."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x, gy, w, b, a = _norm_bwd_inputs(g, shape, dtype, cuda, False, "one")
    card, occupancy = _card(cuda.index or 0)
    plan = instance_norm_backward_plan(shape[0], shape[1], math.prod(shape[2:]), dtype, True, card, occupancy)
    assert plan["path"] == "persistent" and plan["per_unit"] > 1 and plan["launches"] == 1
    _norm_bwd_check(x, gy, w, b, a, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gamma", [0.0, 1e-4])
def test_norm_backward_kernel_at_a_zero_weight(cuda, dtype, gamma):
    """A weight of 0 or 1e-4: dx is 0 or tiny, and the weight's grad, the sum of gz x^,
    still comes from x (not from the output, which holds no x^ at 0)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x, gy, w, b, a = _norm_bwd_inputs(g, (2, 16, 6, 7, 8), dtype, cuda, True, "one", gamma=gamma)
    _norm_bwd_check(x, gy, w, b, a, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [2, 16, 24])
def test_norm_backward_kernel_unaligned_inputs(cuda, dtype, c):
    """x and g one element into their storage take the general path (one element a load)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    shape = (2, 5, 6, 7, c)
    n = torch.Size(shape).numel()
    x = (torch.randn(1 + n, generator=g, device=cuda) * 2).to(dtype)[1:].view(shape).permute(0, 4, 1, 2, 3)
    gy = torch.randn(1 + n, generator=g, device=cuda).to(dtype)[1:].view(shape).permute(0, 4, 1, 2, 3)
    w = (torch.rand((c,), generator=g, device=cuda) + 0.5).to(dtype)
    b = torch.randn((c,), generator=g, device=cuda).to(dtype)
    a = torch.full((1,), 0.25, device=cuda).to(dtype)
    _norm_bwd_check(x, gy, w, b, a, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_autograd_on_the_kernels(cuda, dtype):
    """Autograd through the wrapper, a channel-first grad coming back: the forward with its
    statistics and the backward kernel, one launch each; against autograd of the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x, _, w, b, a = _norm_bwd_inputs(g, (2, 16, 6, 7, 8), dtype, cuda, True, "per_channel")
    gy = torch.randn(x.shape, generator=g, device=cuda).to(dtype)  # NCDHW memory
    params = [t.requires_grad_() for t in (x, w, b, a)]
    before = instance_norm_prelu.launches, instance_norm_prelu_backward.launches
    got = torch.autograd.grad(instance_norm_prelu(x, w, b, a), params, gy)
    assert (instance_norm_prelu.launches, instance_norm_prelu_backward.launches) == (before[0] + 1, before[1] + 1)
    ref = torch.autograd.grad(instance_norm_prelu_plain(x, w, b, a), params, gy)
    for t, r in zip(got, ref):
        # the kernel's and the plain version's statistics differ in their last bits, and
        # the parameter grads are sums over the batch and the space
        _assert_close(t, r, dtype)


def _norm_bwd_plan(x):
    """The backward's plan the wrapper launches for x (B, C, *spatial) on its card."""
    return _backward_args(tuple(x.shape), x.dtype, x.device.index or 0, x.data_ptr() % 16 == 0)[0]


# (shape, path, unit groups > 1): each path of the backward's plan, forced by the shape in
# every type: x and g on chip (a vector a channel group, and a vector of whole voxels), the
# persistent grid with one and with several groups of units, and the general path
NORM_BWD_PATHS = [((2, 64, 6, 6, 6), "onchip", False), ((3, 2, 9, 8, 7), "onchip", False),
                  ((1, 768, 3, 3, 3), "onchip", False), ((2, 24, 24, 24, 24), "persistent", False),
                  ((3, 24, 37, 41, 43), "persistent", False), ((2, 2, 40, 40, 40), "persistent", False),
                  ((2, 48, 96, 96, 96), "persistent", True), ((2, 3, 9, 10, 11), "general", False),
                  ((3, 7, 5, 6, 7), "general", False), ((40, 3, 64, 64, 64), "general", True)]
# the norm sites of both training steps at batch 1: (C, spatial)
STEP_NORM_SHAPES = sorted({(c, sp) for c, sp, _, _ in list(SWIN_NORM_SITES) + list(UNET_NORM_SITES)})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,path,several", NORM_BWD_PATHS)
def test_norm_backward_kernel_paths(cuda, dtype, shape, path, several):
    """Each path of the backward's plan, one launch, two calls bit for bit, against the
    plain version; with an affine and a slope."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x, gy, w, b, a = _norm_bwd_inputs(g, shape, dtype, cuda, True, "one")
    p = _norm_bwd_plan(x)
    assert p["path"] == path and p["launches"] == 1 and (p["unit_groups"] > 1) == several
    _norm_bwd_check(x, gy, w, b, a, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,spatial", STEP_NORM_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_norm_backward_kernel_at_the_step_sites(cuda, dtype, c, spatial, aligned):
    """The norm sites of the UNet and SwinUNETR training steps at batch 1, aligned and one
    element past a 16-byte boundary (the general path), each with a per-channel slope."""
    g = torch.Generator(device=cuda).manual_seed(c)
    x, gy, w, b, a = _norm_bwd_inputs(g, (1, c, *spatial), dtype, cuda, True, "per_channel")
    if not aligned:
        x, gy = (_unaligned_channels_last(t) for t in (x, gy))
        assert _norm_bwd_plan(x)["path"] == "general"
    _norm_bwd_check(x, gy, w, b, a, dtype)


def _unaligned_channels_last(t):
    """t's values, channels-last, one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    flat[1:] = t.permute(0, *range(2, t.ndim), 1).flatten()
    return flat[1:].view(t.shape[0], *t.shape[2:], t.shape[1]).permute(0, t.ndim - 1, *range(1, t.ndim - 1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 24, 24, 24, 24), (2, 48, 96, 96, 96)])
def test_norm_backward_kernel_at_a_zero_weight_on_the_grid(cuda, dtype, shape):
    """A weight of 0 on the persistent grid: dx is 0, and the weight's grad still comes
    from x."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x, gy, w, b, a = _norm_bwd_inputs(g, shape, dtype, cuda, True, "one", gamma=0.0)
    assert _norm_bwd_plan(x)["path"] == "persistent"
    _norm_bwd_check(x, gy, w, b, a, dtype)


def test_norm_backward_refuses_a_grid_the_card_cannot_hold(cuda, monkeypatch):
    """A cooperative grid of more blocks than the card holds at once is refused by the
    launch and raises: nothing falls back to the plain version, nothing is counted, and
    the next launch on the same scratch runs."""
    g = torch.Generator(device=cuda).manual_seed(15)
    x, gy, w, b, a = _norm_bwd_inputs(g, (2, 24, 24, 24, 24), torch.float32, cuda, True, "one")
    with torch.inference_mode():
        _, stats = _forward(x, w, b, a, 1e-5, True)
    p, plan = _backward_args(tuple(x.shape), x.dtype, cuda.index or 0, True)
    assert p["path"] == "persistent"
    per_unit = _card(cuda.index or 0)[0][0] * p["per_sm"] // p["units_per_group"] + 1
    units = 2 * 24 // p["group"]
    big = dict(p, per_unit=per_unit, blocks=per_unit * p["units_per_group"],
               scratch=2 + 3 * units * per_unit * p["group"])
    arr = (ctypes.c_longlong * 13)(*plan)
    arr[8], arr[9] = big["blocks"], per_unit
    monkeypatch.setattr(fast_norm, "_backward_args", lambda *args: (big, arr))
    before = instance_norm_prelu_backward.launches
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA launch failed"):
        instance_norm_prelu_backward(gy, x, stats, w, b, a)
    assert instance_norm_prelu_backward.launches == before
    monkeypatch.undo()
    _norm_bwd_check(x, gy, w, b, a, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_norm_backward_host_plan_is_the_cards(cuda, dtype, aligned):
    """On an H100 the plan made without a card (its model of the occupancy) is the one the
    wrapper launches, at every norm site of both training steps and on the path grid."""
    card, occupancy = _card(cuda.index or 0)
    if card != H100:
        pytest.skip(f"the host model is an H100's; this card has {card[0]} SMs, {card[1]} B a block")
    shapes = [(4, c, sp) for c, sp in STEP_NORM_SHAPES] + [(s[0], s[1], s[2:]) for s, _, _ in NORM_BWD_PATHS]
    for bsz, c, sp in shapes:
        n = math.prod(sp)
        assert (instance_norm_backward_plan(bsz, c, n, dtype, aligned)
                == instance_norm_backward_plan(bsz, c, n, dtype, aligned, card, occupancy)), (bsz, c, sp)


def test_small_unet_train_step_on_card_matches_cpu(cuda):
    """One float32 step of a small UNet's loss on the card against the CPU's: the loss and
    every parameter's grad. The PReLU slopes are 1, so that no activation near 0 takes the
    other branch on one side of the comparison; the conv biases that an instance norm
    follows have an exact grad of 0 and are held to 1e-3 of their weight's grad instead."""
    from monai_tpu_torch.losses import DiceCELoss
    from monai_tpu_torch.networks.blocks.convolutions import Convolution

    net = UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, generator=torch.Generator().manual_seed(0),
               device="cpu")
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.PReLU):
                m.weight.fill_(1.0)
    zero = {f"{name}.conv.bias" for name, m in net.named_modules()
            if isinstance(m, Convolution) and "adn" in m._modules and "N" in m.adn._modules}
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((2, 1, 16, 16, 16), generator=gen)
    y = (torch.rand((2, 1, 16, 16, 16), generator=gen) > 0.5).float()
    loss_fn = DiceCELoss(to_onehot_y=True, softmax=True)
    ref_loss = loss_fn(net(x), y)
    ref_loss.backward()
    ref = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.zero_grad()
    net.to(cuda)
    loss = loss_fn(net(x.to(cuda)), y.to(cuda))
    loss.backward()
    assert abs(loss.item() - ref_loss.item()) <= 1e-5 * abs(ref_loss.item())
    grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    for k, r in ref.items():
        if k in zero:
            weight = k[:-4] + "weight"
            for g in (grads, ref):
                assert g[k].abs().max().item() <= 1e-3 * g[weight].abs().max().item(), k
        else:
            assert (grads[k] - r).abs().max().item() <= 1e-3 * r.abs().max().item(), k


def test_float32_unet_and_blur_ignore_the_tf32_setting(cuda):
    """The spleen bundle's batch-norm UNet and the Gaussian blur give the same bits in
    float32 whether torch lets cuDNN use TF32 (its default) or not: the port runs its
    cuDNN calls in full float32 on float32 inputs."""
    from monai_tpu_torch.ops.gaussian import gaussian_filter

    net = UNet(3, 1, 2, (16, 32, 64, 128, 256), (2, 2, 2, 2), num_res_units=2, norm="batch",
               generator=torch.Generator().manual_seed(0), device=cuda).eval()
    x = torch.rand((2, 1, 64, 64, 64), generator=torch.Generator().manual_seed(1)).to(cuda)
    out = {}
    torch.backends.cudnn.deterministic = True  # the same algorithms, run to run
    try:
        with torch.inference_mode():
            for tf32 in (False, True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                out.setdefault(tf32, []).append((net(x), gaussian_filter(x, 2.0)))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, False
    (a, ga), (b, gb) = out[False]
    (c, gc), = out[True]
    assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(ga, gb) and torch.equal(ga, gc)


# (windows, heads, N, D, mask rows or None): the BTCV bundle's SwinUNETR (feature size 48)
# at batch 4 of 96^3 has D = 16 at (1372, 3, 343), (256, 6, 343), (32, 12, 343), (4, 24,
# 216), one of each pair but the last masked; shrunk here in windows, not in N or D. The
# last two: four windows a mask row as at the step's masked sites, with runs over several
# mask rows and several runs; and many windows without a mask.
ATTN_BWD_SITES = [(12, 3, 343, 16, 4), (12, 3, 343, 16, None), (8, 6, 343, 16, 8), (4, 24, 216, 16, None),
                  (12, 3, 343, 8, 4), (4, 24, 216, 8, None), (5, 2, 27, 8, 5), (7, 1, 64, 16, None),
                  (384, 3, 343, 16, 96), (200, 2, 216, 8, None)]


def _attention_bwd_inputs(g, b, h, n, d, nw, dtype, device):
    q, k, v, bias, mask = _attention_inputs(g, b, h, n, d, nw, dtype, device)
    q = (q.float() * d ** -0.5).to(dtype)
    out, lse = _attention_forward(q, k, v, bias, mask, with_lse=True)
    dout = torch.randn((b, h, n, d), generator=g, device=device).to(dtype)
    return q, k, v, bias, mask, out, dout, lse


def _assert_grads_close(got, ref, dtype):
    """dq, dk, dv (in the input type) and dbias (float32), each at the input type's gate."""
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype
        _assert_close(a, r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,nw", ATTN_BWD_SITES)
def test_window_attention_backward_kernel_matches_plain(cuda, dtype, b, h, n, d, nw):
    g = torch.Generator(device=cuda).manual_seed(n + d)
    q, k, v, bias, mask, out, dout, lse = _attention_bwd_inputs(g, b, h, n, d, nw, dtype, cuda)
    before = fused_window_attention_backward.launches
    got = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
    assert fused_window_attention_backward.launches == before + 1
    ref = fused_window_attention_backward_plain(q, k, v, bias, mask, out, dout)
    _assert_grads_close(got, ref, dtype)
    again = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # deterministic: the same bits twice


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [4, 12, 20, 32])
@pytest.mark.parametrize("n", [27, 125, 512, 729])
@pytest.mark.parametrize("nw", [None, 3])
def test_window_attention_backward_kernel_takes_any_head_dim_to_32(cuda, dtype, d, n, nw):
    """Head dims up to 32 (each runs the instance of D rounded up to 8, 16 or 32) and any
    N up to the 9^3 window, with and without a mask."""
    g = torch.Generator(device=cuda).manual_seed(d * 1000 + n)
    q, k, v, bias, mask, out, dout, lse = _attention_bwd_inputs(g, 6, 2, n, d, nw, dtype, cuda)
    assert window_attention_backward_plan(q, k, v, bias, mask)["head_dim"] == (8 if d <= 8 else 16 if d <= 16 else 32)
    got = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
    _assert_grads_close(got, fused_window_attention_backward_plain(q, k, v, bias, mask, out, dout), dtype)
    again = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,n", [(8, 343), (16, 216), (12, 729)])
@pytest.mark.parametrize("nw", [None, 2])
def test_window_attention_forward_writes_the_log_sum_exp(cuda, dtype, d, n, nw):
    """Each forward instance (tensor-core, FMA, generic) writes the rows' log-sum-exp
    under autograd, and the same output as without it."""
    g = torch.Generator(device=cuda).manual_seed(d + n)
    q, k, v, bias, mask = _attention_inputs(g, 4, 3, n, d, nw, dtype, cuda)
    out, lse = _attention_forward(q, k, v, bias, mask, with_lse=True)
    assert torch.equal(out, _attention_forward(q, k, v, bias, mask)[0])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    if mask is not None:
        s = (s.view(-1, nw, 3, n, n) + mask[None, :, None]).view(4, 3, n, n)
    ref = torch.logsumexp(s, dim=-1)
    assert (lse - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nw", [None, 2])
def test_window_attention_autograd_on_the_kernels(cuda, dtype, nw):
    """Autograd through the wrapper: one forward and one backward launch, the grads of q,
    k, v and bias against the plain backward on the forward's output (the JAX rule's D =
    sum dO.O; autograd of the plain forward would take D = sum P dP, which in bfloat16
    differs from it by more than the gate), and against autograd of the plain forward in
    float32, where the two agree; no grad to the mask."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, bias, mask = _attention_inputs(g, 8, 3, 343, 16, nw, dtype, cuda)
    params = [t.requires_grad_() for t in (q, k, v, bias)]
    dout = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    before = fused_window_attention.launches, fused_window_attention_backward.launches
    out = fused_window_attention(q, k, v, bias, mask)
    got = torch.autograd.grad(out, params, dout)
    assert (fused_window_attention.launches, fused_window_attention_backward.launches) == (before[0] + 1,
                                                                                           before[1] + 1)
    plain = [t.detach() for t in (q, k, v, bias)]
    _assert_grads_close(got, fused_window_attention_backward_plain(*plain, mask, out.detach(), dout), dtype)
    if dtype == torch.float32:
        _assert_grads_close(got, torch.autograd.grad(fused_window_attention_plain(q, k, v, bias, mask), params, dout),
                            dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,offset", [(16, 1), (10, 0), (10, 1)])
def test_window_attention_backward_kernel_unaligned_rows(cuda, dtype, d, offset):
    """q, k, v and dO one element into their storage (not 16-byte aligned), or with rows of
    D = 10 (not whole 16-byte pieces): the kernel copies them an element at a time."""
    g = torch.Generator(device=cuda).manual_seed(d + offset)
    b, h, n, nw = 8, 3, 343, 4
    q, k, v, bias, mask, out, dout, lse = _attention_bwd_inputs(g, b, h, n, d, nw, dtype, cuda)
    q, k, v, dout = (torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape) for x in (q, k, v, dout))
    got = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
    _assert_grads_close(got, fused_window_attention_backward_plain(q, k, v, bias, mask, out, dout), dtype)


def test_window_attention_backward_refuses_a_head_dim_past_32(cuda):
    """D = 64 (past the backward's instances): the plan and the wrapper raise naming the
    shape, and no launch is counted."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, bias, mask, out, dout, lse = _attention_bwd_inputs(g, 2, 1, 27, 64, None, torch.float32, cuda)
    before = fused_window_attention_backward.launches
    with pytest.raises(ValueError, match=r"\(2, 1, 27, 64\)"):
        window_attention_backward_plan(q, k, v, bias)
    with pytest.raises(ValueError, match=r"\(2, 1, 27, 64\)"):
        fused_window_attention_backward(q, k, v, bias, None, out, dout, lse)
    assert fused_window_attention_backward.launches == before


def test_window_attention_backward_plan_at_the_btcv_sites(cuda):
    """The first stage's site (1372 windows, 343 masks): the runs cover every window once,
    64 keys a block, one block an SM, and at least as many main blocks as fill the card
    once."""
    q = torch.empty((1372, 3, 343, 16), device=cuda)
    bias, mask = torch.empty((3, 343, 343), device=cuda), torch.empty((343, 343, 343), device=cuda)
    plan = window_attention_backward_plan(q, q, q, bias, mask)
    assert plan["head_dim"] == 16 and plan["splits"] * plan["windows_per_block"] >= 1372
    assert (plan["splits"] - 1) * plan["windows_per_block"] < 1372
    assert (plan["route"], plan["key_tile"], plan["blocks_per_sm"]) == ("tf32x3", 64, 1)
    assert plan["key_tiles"] == 6 and plan["blocks"] == 3 * 6 * plan["splits"]  # every (window, head, key) once
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan["blocks"] >= sms * plan["blocks_per_sm"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,nw", list(SWIN_ATTN_SITES) + list(BENCH_ATTN_SITES) + STEP_D8_SITES)
def test_window_attention_backward_host_plan_is_the_cards(cuda, dtype, b, h, n, d, nw):
    """``attention_bwd_plan`` on the host, given the card's SM count and the blocks an SM
    holds as the card's plan says, is the card's own plan at every attention site of the
    float32 Swin step and of the bench SwinUNETR, for aligned inputs and for inputs one
    element into their storage."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    bias = torch.empty((h, n, n), device=cuda)
    mask = None if nw is None else torch.empty((nw, n, n), device=cuda)
    for offset in (0, 1):
        q = torch.empty(b * h * n * d + offset, dtype=dtype, device=cuda)[offset:].view(b, h, n, d)
        card = window_attention_backward_plan(q, q, q, bias, mask)
        assert card == attention_bwd_plan(b, h, n, d, nw or 0, dtype, sms, card["blocks_per_sm"]), offset


@pytest.mark.parametrize("b,h,n,d,nw", [(12, 3, 343, 16, 4), (4, 24, 216, 8, None), (5, 2, 27, 8, None),
                                        (1, 2, 27, 8, None), (6, 2, 729, 32, 3)])
def test_window_attention_backward_runs_the_route_its_plan_names(cuda, b, h, n, d, nw):
    """The route the plan names is the one the kernel ran, with the plan's CUDA launches:
    three with partials, two where one key tile and one run leave none."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    q, k, v, bias, mask, out, dout, lse = _attention_bwd_inputs(g, b, h, n, d, nw, torch.float32, cuda)
    plan = window_attention_backward_plan(q, k, v, bias, mask)
    assert plan["route"] == "tf32x3"
    before = fused_window_attention_backward.launches, fused_window_attention_backward.cuda_launches
    got = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
    assert (fused_window_attention_backward.launches,
            fused_window_attention_backward.cuda_launches) == (before[0] + 1, before[1] + plan["launches"])
    assert plan["launches"] == (3 if plan["dq_partials"] or plan["dbias_partials"] else 2)
    _assert_grads_close(got, fused_window_attention_backward_plain(q, k, v, bias, mask, out, dout), torch.float32)


def test_float32_swin_decoder_step_ignores_the_tf32_setting(cuda):
    """Every grad of the decoder (the UNETR blocks and the output conv: their 1x1 and
    transposed cuDNN convs, forward and backward) in a float32 step of a SwinUNETR is the
    same bits whether torch lets cuDNN use TF32 (its default) or not; torch leaves the
    float32 Linear layers in full float32 by default."""
    net = SwinUNETR(1, 3, feature_size=24, generator=torch.Generator().manual_seed(0), device=cuda)
    x = torch.rand((2, 1, 64, 64, 64), generator=torch.Generator().manual_seed(1)).to(cuda)
    y = torch.rand((2, 3, 64, 64, 64), generator=torch.Generator().manual_seed(2)).to(cuda)
    grads = {}
    torch.backends.cudnn.deterministic = True  # the same algorithms, run to run
    try:
        for tf32 in (False, True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            net.zero_grad(set_to_none=True)
            torch.nn.functional.mse_loss(net(x), y).backward()
            grads.setdefault(tf32, []).append({k: p.grad.clone() for k, p in net.named_parameters()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, False
    assert torch.backends.cuda.matmul.allow_tf32 is False  # torch's default: Linear layers in full float32
    (a, b), (c,) = grads[False], grads[True]
    decoder = [k for k in a if not k.startswith("swinViT.")]
    assert len(decoder) > 50
    for k in decoder:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
