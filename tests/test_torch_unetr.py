"""The port's UNETR, ViT, ViTAutoEnc and their blocks against monai_tpu's, on the CPU, in float32.

Small widths (hidden 32, 4 heads, mlp 64, feature size 4, 32-voxel images in 3-D and 2-D):
the shapes and the wiring of the BTCV recipe's UNETR at a cost the CPU takes. Every JAX
module is built abstractly (``nnx.eval_shape``) and given weights from a numpy seed,
biases and norm scales included, so a mis-mapped bias or scale shows; the weights reach the
port through ``unetr_state_dict_from_jax`` / ``vit_state_dict_from_jax``. The JAX forwards
are jitted, one program a shape.

Tolerances, relative to max|ref|: blocks and nets' forwards 1e-5 (float32 sums in another
order through ~20 layers); UNETR's input and parameter grads 1e-4 of each grad's own
max|ref| (sums in another order through the forward and the backward; the LeakyReLU's kink
moves nothing at these inputs), but for one weight whose grad comes only through a norm's
eps (``test_unetr_grads_match_jax`` says which and how it is held).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from monai_tpu.networks.blocks import attention as jax_attention
from monai_tpu.networks.blocks import dynunet_block as jax_dynunet
from monai_tpu.networks.nets import unetr as jax_unetr
from monai_tpu.networks.nets import vit as jax_vit
from monai_tpu_torch.bundle import ComponentLocator
from monai_tpu_torch.networks.blocks import (CrossAttentionBlock, PatchEmbeddingBlock, SABlock, TransformerBlock,
                                             UnetrPrUpBlock)
from monai_tpu_torch.networks.nets import UNETR, ViT, ViTAutoEnc
from monai_tpu_torch.networks.weights import unetr_state_dict_from_jax, vit_state_dict_from_jax

TOL_FWD, TOL_GRAD = 1e-5, 1e-4
SMALL = dict(feature_size=4, hidden_size=32, mlp_dim=64, num_heads=4)


def _fill(module, seed: int) -> dict:
    """Give every variable of an abstract nnx module a value drawn with numpy; return
    {path: array} of its parameters."""
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
        if leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("bias", "position_embeddings", "cls_token"):
            a = rng.uniform(-0.2, 0.2, shape)
        else:  # kernels: fan-in scaled
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        a = a.astype(np.float32)
        var.set_value(jnp.asarray(a))
        params[".".join(map(str, path))] = a
    return params


def _abstract(make, seed: int = 0):
    module = nnx.eval_shape(lambda: make(nnx.Rngs(0)))
    return module, _fill(module, seed)


def _jax_apply(module, *args):
    graphdef, state = nnx.split(module)
    out = jax.jit(lambda s, *a: nnx.merge(graphdef, s)(*a))(state, *map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port(module, params, state_dict_fn=vit_state_dict_from_jax):
    module.load_state_dict(state_dict_fn(params), strict=True)
    return module.eval()


# --- the attention blocks, each alone ----------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_sablock_matches_jax(causal):
    ref, params = _abstract(lambda r: jax_attention.SABlock(32, 4, qkv_bias=True, causal=causal, rngs=r))
    port = _port(SABlock(32, 4, qkv_bias=True, causal=causal), params)
    x = _rand(1, 2, 9, 32)
    assert _rel(port(torch.from_numpy(x)).detach(), _jax_apply(ref, x)) <= TOL_FWD


def test_cross_attention_block_matches_jax():
    ref, params = _abstract(lambda r: jax_attention.CrossAttentionBlock(32, 4, context_input_size=24, rngs=r))
    port = _port(CrossAttentionBlock(32, 4, context_input_size=24), params)
    x, ctx = _rand(2, 2, 7, 32), _rand(3, 2, 5, 24)
    assert _rel(port(torch.from_numpy(x), torch.from_numpy(ctx)).detach(), _jax_apply(ref, x, ctx)) <= TOL_FWD


def test_transformer_block_with_cross_attention_matches_jax():
    ref, params = _abstract(lambda r: jax_attention.TransformerBlock(32, 64, 4, with_cross_attention=True, rngs=r))
    port = _port(TransformerBlock(32, 64, 4, with_cross_attention=True), params)
    x, ctx = _rand(4, 2, 8, 32), _rand(5, 2, 6, 32)
    assert _rel(port(torch.from_numpy(x), torch.from_numpy(ctx)).detach(), _jax_apply(ref, x, ctx)) <= TOL_FWD


@pytest.mark.parametrize("proj_type,dims", [("conv", 3), ("perceptron", 3), ("perceptron", 2)])
def test_patch_embedding_block_matches_jax(proj_type, dims):
    img, patch = (16, 8, 12)[:dims], (4, 4, 2)[:dims]
    ref, params = _abstract(lambda r: jax_attention.PatchEmbeddingBlock(
        2, img, patch, 32, 4, proj_type=proj_type, spatial_dims=dims, rngs=r))
    port = _port(PatchEmbeddingBlock(2, img, patch, 32, 4, proj_type=proj_type, spatial_dims=dims), params)
    x = _rand(6, 2, 2, *img)
    assert _rel(port(torch.from_numpy(x)).detach(), _jax_apply(ref, x)) <= TOL_FWD


# --- ViT and ViTAutoEnc ------------------------------------------------------------------

@pytest.mark.parametrize("classification", [False, True])
def test_vit_matches_jax(classification):
    kw = dict(hidden_size=32, mlp_dim=64, num_layers=3, num_heads=4, classification=classification, num_classes=3)
    ref, params = _abstract(lambda r: jax_vit.ViT(1, 16, 4, proj_type="perceptron", rngs=r, **kw))
    port = _port(ViT(1, 16, 4, proj_type="perceptron", device="cpu", **kw), params)
    x = _rand(7, 2, 1, 16, 16, 16)
    want, want_hidden = _jax_apply(ref, x)
    got, got_hidden = port(torch.from_numpy(x))
    assert _rel(got.detach(), want) <= TOL_FWD
    assert len(got_hidden) == 3 and all(_rel(g.detach(), w) <= TOL_FWD for g, w in zip(got_hidden, want_hidden))
    if classification:
        assert ("classification_head.0.weight" in port.state_dict()) and np.abs(want).max() <= 1  # the tanh head


def test_vit_autoenc_matches_jax():
    kw = dict(hidden_size=32, mlp_dim=64, num_layers=2, num_heads=4, deconv_chns=8, out_channels=2)
    ref, params = _abstract(lambda r: jax_vit.ViTAutoEnc(1, 16, 4, rngs=r, **kw))
    port = _port(ViTAutoEnc(1, 16, 4, device="cpu", **kw), params)
    x = _rand(8, 2, 1, 16, 16, 16)
    (want, _), (got, _) = _jax_apply(ref, x), port(torch.from_numpy(x))
    assert got.shape == (2, 2, 16, 16, 16)
    assert _rel(got.detach(), want) <= TOL_FWD


def test_unetr_pr_up_block_without_conv_block_matches_jax():
    """``conv_block=False``: the JAX ``blocks.<i>.0`` transposed convs are the port's
    ``blocks.<i>``."""
    ref, params = _abstract(lambda r: jax_dynunet.UnetrPrUpBlock(3, 8, 4, num_layer=2, conv_block=False, rngs=r))
    port = UnetrPrUpBlock(3, 8, 4, num_layer=2, conv_block=False)
    state = unetr_state_dict_from_jax({f"e.{k}": v for k, v in params.items()})  # as UNETR's encoder "e"
    port.load_state_dict({k[len("e."):]: v for k, v in state.items()}, strict=True)
    x = _rand(9, 2, 8, 3, 2, 3)
    want = np.moveaxis(_jax_apply(ref, np.moveaxis(x, 1, -1)), -1, 1)
    assert _rel(port(torch.from_numpy(x)).detach(), want) <= TOL_FWD


# --- UNETR -------------------------------------------------------------------------------

def _unetr_pair(proj_type: str, dims: int, seed: int = 0):
    kw = dict(SMALL, proj_type=proj_type, spatial_dims=dims)
    ref, params = _abstract(lambda r: jax_unetr.UNETR(1, 3, 32, rngs=r, **kw), seed)
    port = UNETR(1, 3, 32, device="cpu", **kw)
    port.load_state_dict(unetr_state_dict_from_jax(params), strict=True)
    return ref, port.eval()


@pytest.mark.parametrize("proj_type,dims", [("conv", 3), ("perceptron", 2), ("conv", 2)])
def test_unetr_forward_matches_jax(proj_type, dims):
    """The perceptron in 3-D is ``test_unetr_grads_match_jax``'s forward."""
    ref, port = _unetr_pair(proj_type, dims)
    x = _rand(10, 2, 1, *(32,) * dims)
    got = port(torch.from_numpy(x)).detach()
    assert got.shape == (2, 3, *(32,) * dims)
    assert _rel(got, _jax_apply(ref, x)) <= TOL_FWD


def test_unetr_grads_match_jax():
    """The BTCV recipe's form (perceptron, instance norm with affine, residual blocks), 3-D:
    the forward, and the grads of sum(out * r) for the input and every parameter."""
    ref, port = _unetr_pair("perceptron", 3, seed=1)
    x, r = _rand(11, 1, 1, 32, 32, 32), _rand(12, 1, 3, 32, 32, 32)
    graphdef, params, rest = nnx.split(ref, nnx.Param, ...)

    def forward_and_grads(p, xx):
        out, vjp = jax.vjp(lambda p_, x_: nnx.merge(graphdef, p_, rest)(x_), p, xx)
        return out, vjp(jnp.asarray(r))

    out, (g_params, g_x) = jax.jit(forward_and_grads)(params, jnp.asarray(x))
    want = unetr_state_dict_from_jax({".".join(map(str, k)): np.asarray(v.get_value())
                                      for k, v in g_params.flat_state()})
    xt = torch.from_numpy(x).requires_grad_()
    y = port.train()(xt)
    assert _rel(y.detach(), np.asarray(out)) <= TOL_FWD
    (y * torch.from_numpy(r)).sum().backward()
    assert _rel(xt.grad, np.asarray(g_x)) <= TOL_GRAD
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    # encoder1's 1x1 conv3 takes the 1-channel image and norm3 normalises each of its
    # channels, so the output depends on that weight only through the norm's eps against
    # w^2 var(x); the JAX norm takes the variance as E[x^2] - E[x]^2 and its backward from
    # the output, the port's about the mean, and at a weight of 0.06 the two float32 grads
    # differ by 5e-3 of their max: that one is held by its cosine with the JAX grad
    eps_only = "encoder1.layer.conv3.conv.weight"
    cosine = torch.nn.functional.cosine_similarity(got[eps_only].grad.reshape(1, -1), want[eps_only].reshape(1, -1))
    assert cosine.item() >= 0.9999
    worst = max(((_rel(got[k].grad, w.numpy()), k) for k, w in want.items() if k != eps_only))
    assert worst[0] <= TOL_GRAD, worst


def test_unetr_is_a_bundle_target():
    assert ComponentLocator().get_component_module_name("UNETR") == "monai_tpu_torch.networks.nets.unetr"
    assert ComponentLocator().get_component_module_name("ViTAutoEnc") == "monai_tpu_torch.networks.nets.vit"
