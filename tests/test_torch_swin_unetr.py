"""monai_tpu_torch's SwinUNETR and its blocks against monai_tpu's, on the CPU, in float32.

Every JAX module here is built abstractly (``nnx.eval_shape``) and given weights from a
numpy seed, biases and norm scales included, so a mis-mapped bias or scale shows; the
weights reach the port through ``swin_state_dict_from_jax``. The JAX window attention
is forced onto its Pallas kernel (interpret mode on the CPU). Blocks agree to 1e-5, the
whole network to 1e-4 (absolute and relative): ~40 layers of float32 sums in another
order. The port's ``state_dict`` keys are torch MONAI's, and loading them back into a
JAX SwinUNETR with ``torch_compat.load_torch_swin_state`` gives identical outputs.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from monai_tpu.inferers import SlidingWindowInferer as JaxSlidingWindowInferer
from monai_tpu.networks.blocks import attention as jax_attention
from monai_tpu.networks.blocks import dynunet_block as jax_dynunet
from monai_tpu.networks.nets import swin_unetr as jax_swin
from monai_tpu.networks.torch_compat import load_torch_swin_state
from monai_tpu.ops import pallas_window_attention as pwa
from monai_tpu_torch.inferers import SlidingWindowInferer, SlidingWindowInfererAdapt
from monai_tpu_torch.networks.blocks import attention, dynunet_block
from monai_tpu_torch.networks.layers import fast_norm
from monai_tpu_torch.networks.layers.factories import Conv3d
from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu
from monai_tpu_torch.networks.nets import swin_unetr
from monai_tpu_torch.networks.weights import swin_state_dict_from_jax
from monai_tpu_torch.ops.conv3d import conv3d_3x3_same
from monai_tpu_torch.ops.window_attention import fused_window_attention

TOL_BLOCK = dict(atol=1e-5, rtol=1e-5)
TOL_NET = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _pallas_attention(monkeypatch):
    monkeypatch.setattr(pwa, "use_pallas_window_attention", lambda: True)


def _owner(module, path):
    for t in path:
        module = module[int(t)] if str(t).isdigit() else getattr(module, t)
    return module


def _abstract(make):
    return nnx.eval_shape(lambda: make(nnx.Rngs(0)))


def _fill(module, seed: int) -> dict:
    """Give every variable of an abstract nnx module a value drawn with numpy; return
    {path: array} of the parameters and relative-position indices."""
    rng = np.random.RandomState(seed)
    params = {}
    for path, var in nnx.state(module).flat_state():
        shape, kind, leaf = var.get_value().shape, type(var).__name__, path[-1]
        if kind == "RngKey":
            var.set_value(jax.random.key(0))
            continue
        if kind == "RngCount":
            var.set_value(jnp.zeros(shape, jnp.uint32))
            continue
        if leaf == "relative_position_index":
            a = jax_swin._rel_pos_index(_owner(module, path[:-1]).window_size).astype(np.int32)
        elif leaf == "relative_position_bias_table":
            a = rng.randn(*shape) * 0.5
        elif leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias":
            a = rng.uniform(-0.2, 0.2, shape)
        else:  # kernels: fan-in scaled
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        a = a if a.dtype == np.int32 else a.astype(np.float32)
        var.set_value(jnp.asarray(a))
        params[".".join(map(str, path))] = a
    return params


def _carry(jax_module, port_module, seed: int = 0):
    port_module.load_state_dict(swin_state_dict_from_jax(_fill(jax_module, seed)))
    return port_module.eval()


def _cl(x: np.ndarray) -> torch.Tensor:
    """A channels-last numpy array as the port's channel-first tensor (channels-last memory)."""
    return torch.from_numpy(x).movedim(-1, 1)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_apply(module, *args):
    """The module's forward on numpy inputs, compiled as one program (cheaper on the CPU
    than dispatching each op)."""
    graphdef, state = nnx.split(module)
    return np.asarray(jax.jit(lambda s, *a: nnx.merge(graphdef, s)(*a))(state, *map(jnp.asarray, args)))


# --- helpers equal the JAX package's ---------------------------------------------------

@pytest.mark.parametrize("shape,window", [((2, 6, 9, 4, 5), (3, 3, 2)), ((3, 6, 4, 2), (2, 2))])
def test_window_partition_and_reverse_equal_jax(shape, window):
    x = _rand(0, *shape)
    got = swin_unetr.window_partition(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_swin.window_partition(jnp.asarray(x), window)))
    dims = (shape[0], *shape[1:-1])
    np.testing.assert_array_equal(swin_unetr.window_reverse(got, window, dims).numpy(), x)


@pytest.mark.parametrize("dims,window,shift", [((14, 14, 14), (7, 7, 7), (3, 3, 3)), ((6, 9, 4), (3, 3, 2), (1, 1, 1)),
                                              ((6, 6, 6), (6, 3, 3), (0, 1, 1)), ((8, 6), (4, 3), (2, 1))])
def test_compute_mask_equals_jax(dims, window, shift):
    got = swin_unetr.compute_mask(dims, window, shift)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jax_swin.compute_mask(dims, window, shift))


@pytest.mark.parametrize("window", [(7, 7, 7), (6, 6, 6), (3, 2, 4), (7, 7)])
def test_rel_pos_index_equals_jax(window):
    np.testing.assert_array_equal(swin_unetr._rel_pos_index(window), jax_swin._rel_pos_index(window))


@pytest.mark.parametrize("size", [(48, 48, 48), (6, 6, 6), (3, 3, 3), (6, 14, 7)])
def test_get_window_size_equals_jax(size):
    ws, ss = (7, 7, 7), (3, 3, 3)
    assert swin_unetr.get_window_size(size, ws, ss) == jax_swin.get_window_size(size, ws, ss)
    assert swin_unetr.get_window_size(size, ws) == jax_swin.get_window_size(size, ws)


def test_filter_swinunetr_equals_jax():
    for key in ["encoder.mask_token", "encoder.patch_embed.proj.weight", "encoder.layers1.0.blocks.0.attn.qkv.weight",
                "out.conv.conv.weight", "decoder1.x"]:
        assert swin_unetr.filter_swinunetr(key, 1) == jax_swin.filter_swinunetr(key, 1)


# --- blocks ------------------------------------------------------------------------------

def _conv_block_case(name):
    """(abstract JAX block, port block, [channels-last input]) of a conv block."""
    f = {"res_identity": (jax_dynunet.UnetResBlock, dynunet_block.UnetResBlock, (3, 8, 8, 3, 1)),
         "res_channels": (jax_dynunet.UnetResBlock, dynunet_block.UnetResBlock, (3, 4, 8, 3, 1)),
         "res_stride2": (jax_dynunet.UnetResBlock, dynunet_block.UnetResBlock, (3, 4, 8, 3, 2)),
         "basic": (jax_dynunet.UnetBasicBlock, dynunet_block.UnetBasicBlock, (3, 4, 8, 3, 1))}
    jax_cls, port_cls, args = f[name]
    return (_abstract(lambda r: jax_cls(*args, rngs=r)), port_cls(*args), [_rand(1, 2, 6, 5, 4, args[1])])


@pytest.mark.parametrize("name", ["res_identity", "res_channels", "res_stride2", "basic"])
def test_conv_blocks_match_jax(name):
    jax_block, port_block, (x,) = _conv_block_case(name)
    _carry(jax_block, port_block)
    with torch.inference_mode():
        got = port_block(_cl(x)).movedim(1, -1).numpy()
    np.testing.assert_allclose(got, _jax_apply(jax_block, x), **TOL_BLOCK)


def test_unetr_up_block_matches_jax():
    jax_block = _abstract(lambda r: jax_dynunet.UnetrUpBlock(3, 16, 8, 3, 2, rngs=r))
    port_block = _carry(jax_block, dynunet_block.UnetrUpBlock(3, 16, 8, 3, 2))
    inp, skip = _rand(2, 1, 3, 4, 2, 16), _rand(3, 1, 6, 8, 4, 8)
    with torch.inference_mode():
        got = port_block(_cl(inp), _cl(skip)).movedim(1, -1).numpy()
    np.testing.assert_allclose(got, _jax_apply(jax_block, inp, skip), **TOL_BLOCK)


def test_unet_out_and_unetr_basic_blocks_match_jax():
    jax_out = _abstract(lambda r: jax_dynunet.UnetOutBlock(3, 8, 5, rngs=r))
    jax_enc = _abstract(lambda r: jax_dynunet.UnetrBasicBlock(3, 1, 8, 3, 1, rngs=r))
    port_out = _carry(jax_out, dynunet_block.UnetOutBlock(3, 8, 5), 1)
    port_enc = _carry(jax_enc, dynunet_block.UnetrBasicBlock(3, 1, 8, 3, 1), 2)
    x8, x1 = _rand(4, 2, 4, 5, 3, 8), _rand(5, 1, 6, 4, 5, 1)
    with torch.inference_mode():
        got_out = port_out(_cl(x8)).movedim(1, -1).numpy()
        got_enc = port_enc(_cl(x1)).movedim(1, -1).numpy()
    np.testing.assert_allclose(got_out, _jax_apply(jax_out, x8), **TOL_BLOCK)
    np.testing.assert_allclose(got_enc, _jax_apply(jax_enc, x1), **TOL_BLOCK)


@pytest.mark.parametrize("name", ["mlp", "patch_embed", "patch_embed_norm", "merging", "merging_v2"])
def test_transformer_blocks_match_jax(name):
    make = {
        "mlp": (lambda r: jax_attention.MLPBlock(12, 48, rngs=r), lambda: attention.MLPBlock(12, 48), (2, 5, 12)),
        "patch_embed": (lambda r: jax_attention.PatchEmbed(2, 1, 12, rngs=r), lambda: attention.PatchEmbed(2, 1, 12),
                        (1, 7, 6, 5, 1)),
        "patch_embed_norm": (lambda r: jax_attention.PatchEmbed(2, 2, 12, True, rngs=r),
                             lambda: attention.PatchEmbed(2, 2, 12, True), (2, 4, 5, 6, 2)),
        "merging": (lambda r: jax_swin.PatchMerging(6, rngs=r), lambda: swin_unetr.PatchMerging(6), (1, 5, 4, 3, 6)),
        "merging_v2": (lambda r: jax_swin.PatchMergingV2(6, rngs=r), lambda: swin_unetr.PatchMergingV2(6),
                       (2, 4, 4, 5, 6)),
    }[name]
    jax_block = _abstract(make[0])
    port_block = _carry(jax_block, make[1]())
    x = _rand(6, *make[2])
    with torch.inference_mode():
        got = port_block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_apply(jax_block, x), **TOL_BLOCK)


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 1, 1)])
def test_swin_transformer_block_matches_jax(shift):
    """Padding 5x6x4 to the 3^3 window grid, the cyclic shift and its mask."""
    jax_block = _abstract(lambda r: jax_swin.SwinTransformerBlock(12, 3, (3, 3, 3), shift, rngs=r))
    port_block = _carry(jax_block, swin_unetr.SwinTransformerBlock(12, 3, (3, 3, 3), shift))
    x = _rand(7, 2, 5, 6, 4, 12)
    mask = swin_unetr.compute_mask((6, 6, 6), (3, 3, 3), shift)
    with torch.inference_mode():
        got = port_block(torch.from_numpy(x), mask).numpy()
    np.testing.assert_allclose(got, _jax_apply(jax_block, x, mask.numpy()), **TOL_BLOCK)


def test_basic_layer_matches_jax_and_caches_its_mask():
    jax_layer = _abstract(lambda r: jax_swin.BasicLayer(12, 2, 3, (3, 3, 3), None, qkv_bias=True,
                                                        downsample=jax_swin.PatchMerging, rngs=r))
    port_layer = _carry(jax_layer, swin_unetr.BasicLayer(12, 2, 3, (3, 3, 3), qkv_bias=True,
                                                        downsample=swin_unetr.PatchMerging))
    x = _rand(8, 1, 5, 6, 4, 12)
    with torch.inference_mode():
        got = port_layer(torch.from_numpy(x)).numpy()
        port_layer(torch.from_numpy(x))
    np.testing.assert_allclose(got, _jax_apply(jax_layer, x), **TOL_BLOCK)
    assert len(port_layer._masks) == 1


# --- the whole network ----------------------------------------------------------------

def _jax_swin():
    return _abstract(lambda r: jax_swin.SwinUNETR(1, 14, feature_size=24, rngs=r))


@pytest.fixture(scope="module")
def nets():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pwa, "use_pallas_window_attention", lambda: True)
        jax_net = _jax_swin()
        port = _carry(jax_net, swin_unetr.SwinUNETR(1, 14, feature_size=24, device="cpu"), seed=11)
        graphdef, state = nnx.split(jax_net)
        forward = jax.jit(lambda s, x: nnx.merge(graphdef, s)(x))
        x = np.random.RandomState(12).rand(1, 1, 32, 32, 32).astype(np.float32)
        ref = np.asarray(forward(state, jnp.asarray(x)))
    return jax_net, port, forward, x, ref


def test_swin_unetr_matches_jax(nets):
    """32^3: stage 1 pads 16^3 to 21^3 (27 windows, shifted with the mask), stages 3 and 4
    clamp the window to 4^3 and 2^3 and read the bias index [:n, :n]."""
    _, port, _, x, ref = nets
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 14, 32, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL_NET)


def test_swin_unetr_float16_matches_float32_and_jax(nets):
    """``.to(torch.float16)`` runs: against the port's float32 forward and the JAX net on
    the input rounded to float16, to 2^-10 (float16's relative step) x 40 layers of
    max|ref|. The JAX net computes a float16 input in its float32 parameters' type, so
    it is fed the rounded input as float32 and no second program is compiled."""
    jax_net, port, forward, x, ref32 = nets
    x16 = x.astype(np.float16)
    with torch.inference_mode():
        got = copy.deepcopy(port).to(torch.float16)(torch.from_numpy(x16))
    assert got.shape == (1, 14, 32, 32, 32) and got.dtype == torch.float16
    ref = np.asarray(forward(nnx.split(jax_net)[1], jnp.asarray(x16.astype(np.float32))))
    tol = 2.0 ** -10 * 40
    for r in (ref32, ref):
        assert np.abs(got.float().numpy() - r).max() <= tol * np.abs(r).max()


def test_swin_unetr_feature_size_12_matches_jax():
    """feature_size 12: head dim 4 at every stage (heads 3-6-12-24), which the card's
    window-attention kernel runs in its generic instance."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pwa, "use_pallas_window_attention", lambda: True)
        jax_net = _abstract(lambda r: jax_swin.SwinUNETR(1, 3, feature_size=12, rngs=r))
        port = _carry(jax_net, swin_unetr.SwinUNETR(1, 3, feature_size=12, device="cpu"), seed=14)
        x = np.random.RandomState(15).rand(1, 1, 32, 32, 32).astype(np.float32)
        ref = _jax_apply(jax_net, x)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 3, 32, 32, 32)
    np.testing.assert_allclose(got.numpy(), ref, **TOL_NET)


def _torch_monai_keys() -> list[str]:
    """torch MONAI's SwinUNETR(1, 14, feature_size=24) state_dict keys, in order."""
    keys = ["swinViT.patch_embed.proj.weight", "swinViT.patch_embed.proj.bias"]
    blk = ["norm1.weight", "norm1.bias", "attn.relative_position_bias_table", "attn.relative_position_index",
           "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
           "mlp.linear1.weight", "mlp.linear1.bias", "mlp.linear2.weight", "mlp.linear2.bias"]
    for layer in range(1, 5):
        for b in range(2):
            keys += [f"swinViT.layers{layer}.0.blocks.{b}.{k}" for k in blk]
        keys += [f"swinViT.layers{layer}.0.downsample.{k}" for k in ("reduction.weight", "norm.weight", "norm.bias")]

    def res(prefix, downsample):
        ks = ["conv1.conv.weight", "conv2.conv.weight", "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias"]
        if downsample:
            ks += ["conv3.conv.weight", "norm3.weight", "norm3.bias"]
        return [f"{prefix}.{k}" for k in ks]

    keys += res("encoder1.layer", True)
    for name in ("encoder2", "encoder3", "encoder4", "encoder10"):
        keys += res(f"{name}.layer", False)
    for name in ("decoder5", "decoder4", "decoder3", "decoder2", "decoder1"):
        keys += [f"{name}.transp_conv.conv.weight"] + res(f"{name}.conv_block", True)
    return keys + ["out.conv.conv.weight", "out.conv.conv.bias"]


def test_state_dict_keys_are_torch_monai_names(nets):
    _, port, _, _, _ = nets
    sd = port.state_dict()
    assert list(sd) == _torch_monai_keys()
    assert sd["swinViT.layers1.0.blocks.0.attn.relative_position_index"].dtype == torch.int64
    assert tuple(sd["decoder5.transp_conv.conv.weight"].shape) == (384, 192, 2, 2, 2)  # (I, O, *K)
    assert tuple(sd["swinViT.layers1.0.blocks.0.attn.qkv.weight"].shape) == (72, 24)   # (O, I)


def test_round_trip_through_torch_compat_gives_identical_outputs(nets):
    jax_net, port, forward, x, ref = nets
    jax_net2 = _jax_swin()
    _fill(jax_net2, seed=99)
    load_torch_swin_state(jax_net2, port.state_dict())
    out = forward(nnx.split(jax_net2)[1], jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_sites_layouts_and_cpu_routing(nets, monkeypatch):
    """One forward: 8 window attentions, 20 SAME 3x3x3 convs and 26 instance norms (10
    with the LeakyReLU fused at slope 0.01); the norm and conv kernels get channels-last
    memory, the attention contiguous tensors; on the CPU no kernel is launched."""
    _, port, _, x, _ = nets
    seen = {"attn": [], "conv": [], "norm": []}
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen["conv"].append(inp[0].movedim(1, -1).is_contiguous()))
             for m in port.modules() if isinstance(m, Conv3d) and m.same_3x3x3]

    def attn_spy(q, k, v, bias, mask):
        seen["attn"].append((tuple(q.shape), None if mask is None else mask.shape[0]))
        return fused_window_attention(q, k, v, bias, mask)

    def norm_spy(x, weight, bias, slope, eps):
        seen["norm"].append((x.movedim(1, -1).is_contiguous(), None if slope is None else float(slope)))
        return instance_norm_prelu(x, weight, bias, slope, eps)

    monkeypatch.setattr(swin_unetr, "fused_window_attention", attn_spy)
    monkeypatch.setattr(fast_norm, "instance_norm_prelu", norm_spy)
    before = (fused_window_attention.launches, conv3d_3x3_same.launches, instance_norm_prelu.launches)
    try:
        with torch.inference_mode():
            port(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    # (windows, heads, tokens, head dim), mask rows: 16^3 padded to 21^3, 8^3 to 14^3, then clamped
    assert seen["attn"] == [((27, 3, 343, 8), None), ((27, 3, 343, 8), 27), ((8, 6, 343, 8), None),
                            ((8, 6, 343, 8), 8), ((1, 12, 64, 8), None), ((1, 12, 64, 8), None),
                            ((1, 24, 8, 8), None), ((1, 24, 8, 8), None)]
    assert len(seen["conv"]) == 20 and all(seen["conv"])
    assert len(seen["norm"]) == 26 and all(cl for cl, _ in seen["norm"])
    assert sorted(s for _, s in seen["norm"] if s is not None) == [pytest.approx(0.01)] * 10
    assert (fused_window_attention.launches, conv3d_3x3_same.launches, instance_norm_prelu.launches) == before


def test_slope_buffer_is_not_in_the_state_dict_and_follows_dtype():
    block = dynunet_block.UnetResBlock(3, 2, 4, 3, 1)
    assert "lrelu_slope" not in block.state_dict() and block.fuse_lrelu
    assert block.to(torch.bfloat16).lrelu_slope.dtype == torch.bfloat16


def test_generator_init_is_reproducible():
    a = swin_unetr.SwinUNETR(1, 2, feature_size=12, generator=torch.Generator().manual_seed(3), device="cpu")
    b = swin_unetr.SwinUNETR(1, 2, feature_size=12, generator=torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(), b.state_dict().values()))
    table = a.swinViT.layers1[0].blocks[0].attn.relative_position_bias_table
    assert table.abs().max() <= 0.04 and table.std() > 0.01  # 0.02 x N(0, 1) truncated at 2


def test_rejects_bad_feature_size_and_attention_dropout():
    """A feature size not a multiple of 12 raises; attention dropout is taken at a rate in
    [0, 1) (tests/test_torch_segresnet_vae.py holds it to JAX) and raises at 1."""
    with pytest.raises(ValueError):
        swin_unetr.SwinUNETR(1, 2, feature_size=20, device="cpu")
    net = swin_unetr.SwinUNETR(1, 2, feature_size=12, attn_drop_rate=0.1, device="cpu")
    assert net.swinViT.layers1[0].blocks[0].attn.attn_drop == 0.1
    with pytest.raises(ValueError):
        swin_unetr.SwinUNETR(1, 2, feature_size=12, attn_drop_rate=1.0, device="cpu")


# --- sliding-window inference ------------------------------------------------------------

def test_whole_slice_matches_jax(nets):
    """SlidingWindowInfererAdapt with the port's SwinUNETR against monai_tpu's inferer and
    SwinUNETR on the same weights: (1, 1, 40, 32, 36), roi 32^3, 4 windows, batches of 2."""
    jax_net, port, _, _, _ = nets
    vol = np.random.RandomState(13).rand(1, 1, 40, 32, 36).astype(np.float32)
    inferer = SlidingWindowInfererAdapt(32, sw_batch_size=2, overlap=0.25, mode="gaussian")
    with torch.inference_mode():
        got = inferer(torch.from_numpy(vol), port)
    ref = JaxSlidingWindowInferer(32, sw_batch_size=2, overlap=0.25, mode="gaussian")(jnp.asarray(vol), jax_net)
    assert got.shape == (1, 14, 40, 32, 36) and inferer.sw_batch_size == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_NET)


class _OOMPredictor:
    """Raises ``torch.cuda.OutOfMemoryError`` on window batches larger than ``limit`` and
    on the first ``fail_first`` calls; otherwise a fixed nonlinear map of the windows."""

    def __init__(self, limit: int = 99, fail_first: int = 0):
        self.limit, self.fail_first, self.calls = limit, fail_first, 0

    def __call__(self, w):
        self.calls += 1
        if w.shape[0] > self.limit or self.calls <= self.fail_first:
            raise torch.cuda.OutOfMemoryError("simulated out of memory")
        return torch.cat([torch.tanh(w), w * w], dim=1)


def _adapt_case(predictor):
    vol = torch.from_numpy(np.random.RandomState(14).rand(1, 1, 24, 20, 16).astype(np.float32))
    inferer = SlidingWindowInfererAdapt(8, sw_batch_size=6, overlap=0.25, mode="gaussian")
    with torch.inference_mode():
        got = inferer(vol, predictor)
        ref = SlidingWindowInferer(8, sw_batch_size=6, overlap=0.25, mode="gaussian")(vol, _OOMPredictor())
    return inferer, got, ref


def test_adapt_halves_on_out_of_memory():
    inferer, got, ref = _adapt_case(_OOMPredictor(limit=3))
    assert inferer.sw_batch_size == 3
    torch.testing.assert_close(got, ref)


def test_adapt_stitches_on_the_host_at_batch_one():
    """Every attempt down to one window fails once; the host stitch then runs."""
    inferer, got, ref = _adapt_case(_OOMPredictor(fail_first=3))
    assert inferer.sw_batch_size == 1 and got.device.type == "cpu"
    torch.testing.assert_close(got, ref)


def test_adapt_passes_other_errors_through():
    def broken(w):
        raise ValueError("not a memory error")

    with pytest.raises(ValueError):
        SlidingWindowInfererAdapt(8, sw_batch_size=4)(torch.zeros(1, 1, 8, 8, 8), broken)
