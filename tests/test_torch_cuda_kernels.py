"""The port's CUDA and Triton kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports no JAX,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, relative to max|plain output|: float32 1e-4 (sums in another order);
bfloat16 1e-2 (both versions round an f32 sum to bf16, so they may differ by one bf16
step, at most 2^-7 of the value).
"""
import pytest
import torch

from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu, instance_norm_prelu_plain
from monai_tpu_torch.networks.nets import SwinUNETR, UNet
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same, conv3d_3x3_same_plain
from monai_tpu_torch.ops.window_attention import fused_window_attention, fused_window_attention_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_unaligned_input(cuda, dtype):
    """A contiguous view that is not 16-byte aligned takes the element-wise loads."""
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (1, 4, 5, 6, 16)
    x = torch.randn(1 + torch.Size(shape).numel(), generator=g, device=cuda).to(dtype)[1:].view(shape)
    w = (torch.randn((3, 3, 3, 16, 16), generator=g, device=cuda) / 20).to(dtype)
    with torch.inference_mode():
        _assert_close(conv3d_3x3_same(x, w), conv3d_3x3_same_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,spatial", [(1, (5, 6, 7)), (2, (9, 8, 7)), (3, (4, 4, 4)), (16, (6, 5, 4)),
                                       (100, (3, 4, 5)), (256, (6, 6, 6))])
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


def test_norm_kernel_2d_channels_last(cuda):
    x = torch.randn((2, 8, 10, 12), device=cuda).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        _assert_close(instance_norm_prelu(x), instance_norm_prelu_plain(x), torch.float32)


def test_norm_kernel_rejects_channel_first_memory(cuda):
    x = torch.randn((2, 4, 3, 3, 3), device=cuda)  # contiguous NCDHW, not channels-last
    with torch.inference_mode(), pytest.raises(ValueError):
        instance_norm_prelu(x)


def test_small_unet_on_card_matches_cpu(cuda):
    net = UNet(3, 1, 2, (4, 8, 16), (2, 2), num_res_units=2, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand((2, 1, 16, 16, 16), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("n", [27, 216, 343])
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_kernel_matches_plain(cuda, dtype, d, n, with_mask):
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, nw = 12, 3, 4
    q, k, v = (torch.randn((b, h, n, d), generator=g, device=cuda).to(dtype) for _ in range(3))
    bias = torch.randn((h, n, n), generator=g, device=cuda) * 0.5
    mask = (torch.rand((nw, n, n), generator=g, device=cuda) > 0.5).float() * -100.0 if with_mask else None
    with torch.inference_mode():
        before = fused_window_attention.launches
        got = fused_window_attention(q, k, v, bias, mask)
        assert fused_window_attention.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype
        _assert_close(got, fused_window_attention_plain(q, k, v, bias, mask), dtype)


def test_window_attention_kernel_rejects_other_head_dims(cuda):
    q = torch.zeros((2, 1, 27, 4), device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError):
        fused_window_attention(q, q, q, torch.zeros((1, 27, 27), device=cuda))


def test_small_swin_unetr_on_card_matches_cpu(cuda):
    net = SwinUNETR(1, 3, feature_size=24, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand((2, 1, 32, 32, 32), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
