"""The float32 sites of the Auto3DSeg templates', DynUNet's and UNETR's training steps, and the
host plans of kernel 1's dw and kernel B2's forward and backward there, on the CPU (no JAX).

The sites are those ``chip_smoke.py``'s ``record_sites`` reads off the full-width nets
(phases 14 and 15, which require the sums below): the UNet template (the bench UNet,
instance norm without affine, PReLU) and the SegResNet template (init filters 16) at batch 4
of 96^3, and the nnU-Net plans bridge's 3d_fullres DynUNet (features 32-320, stride-2 stages
from 128^3 down to 4^3, instance norm with affine, LeakyReLU 0.01) at batch 2 of 128^3. At
each: dw's plan takes the FMA route (the small one at 2 -> 2), fits a block and covers CI,
CO and every brick; B2's forward and backward plans are one launch within a block's
shared memory (tests/test_torch_norm_bwd_plan.py's invariants for the backward).
UNETR's (the BTCV recipe's: feature size 16, hidden 768, instance norm without affine,
residual blocks, batch 4 of 96^3; phase 18) come from ``unetr_sites``, which a small UNETR's
own sites, read by hooks on the CPU, check. tests/test_torch_cuda_kernels.py runs the
kernels at these sites on the card.
"""
import pytest
import torch

from monai_tpu_torch.networks.layers.factories import Conv3d
from monai_tpu_torch.networks.layers.fast_norm import InstanceNorm
from monai_tpu_torch.networks.nets import UNETR

from monai_tpu_torch.networks.layers.fast_norm import H100, instance_norm_backward_plan, instance_norm_plan
from monai_tpu_torch.ops.conv3d import wgrad_plan
from test_torch_conv3d_wgrad_plan import BLOCK_SHARED, SM_SHARED, UNET_TRAIN_SITES, _cdiv
from test_torch_norm_bwd_plan import UNET_NORM_SITES, _check_invariants

DYNUNET_FEATURES = (32, 64, 128, 256, 320, 320)
DYNUNET_SIDES = (128, 64, 32, 16, 8, 4)


def _dynunet_sites() -> tuple[dict, dict]:
    """(CI, CO, spatial): count of the 3x3x3 stride-1 convs and (C, spatial, affine, slope):
    count of the norms of the DynUNet: each stage's block (the input block's two convs, the
    second of each strided block) and both convs of each decoder block, on the skip's
    concatenation and after it; two norms a block."""
    convs, norms = {}, {}

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    for i, (f, s) in enumerate(zip(DYNUNET_FEATURES, DYNUNET_SIDES)):
        sp = (s,) * 3
        if i == 0:
            add(convs, (1, f, sp))
        add(convs, (f, f, sp))
        for _ in range(2):
            add(norms, (f, sp, True, 0.01))
        if i < len(DYNUNET_FEATURES) - 1:  # the decoder block that ends at this stage
            add(convs, (2 * f, f, sp))
            add(convs, (f, f, sp))
            for _ in range(2):
                add(norms, (f, sp, True, 0.01))
    return convs, norms


DYNUNET_CONV_SITES, DYNUNET_NORM_SITES = _dynunet_sites()
SEGRESNET_SITES = {(1, 16, (96, 96, 96)): 1, (16, 16, (96, 96, 96)): 4, (32, 32, (48, 48, 48)): 6,
                   (64, 64, (24, 24, 24)): 6, (128, 128, (12, 12, 12)): 8}


def unetr_sites(feature: int, side: int, in_channels: int = 1) -> tuple[dict, dict]:
    """(CI, CO, spatial): count of UNETR's 3x3x3 stride-1 convs and (C, spatial, affine,
    slope): count of its instance norms (no affine, the LeakyReLU's 0.01 fused into norm1),
    at ``feature`` and an image of ``side``^3: its eight ``UnetResBlock``s (encoder1 on the
    image, encoder2's two and encoder3's one after their transposed convs, the four decoder
    blocks on the skips' concatenation), two convs and two norms each, and a third norm where
    the block's channels change."""
    f = feature
    blocks = [(in_channels, f, side), (2 * f, 2 * f, side // 4), (2 * f, 2 * f, side // 2), (4 * f, 4 * f, side // 4),
              (16 * f, 8 * f, side // 8), (8 * f, 4 * f, side // 4), (4 * f, 2 * f, side // 2), (2 * f, f, side)]
    convs, norms = {}, {}

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    for cin, cout, s in blocks:
        sp = (s,) * 3
        add(convs, (cin, cout, sp))
        add(convs, (cout, cout, sp))
        add(norms, (cout, sp, False, 0.01))
        add(norms, (cout, sp, False, None))
        if cin != cout:
            add(norms, (cout, sp, False, None))
    return convs, norms


UNETR_CONV_SITES, UNETR_NORM_SITES = unetr_sites(16, 96)
# (batch, CI, CO, spatial): count, float32
NEW_F32_CONV_SITES = {**{(4, *s): n for s, n in UNET_TRAIN_SITES.items()},
                      **{(4, *s): n for s, n in SEGRESNET_SITES.items()},
                      **{(2, *s): n for s, n in DYNUNET_CONV_SITES.items()}}
# (batch, C, spatial, affine, slope): count, float32
NEW_F32_NORM_SITES = {**{(4, *s): n for s, n in UNET_NORM_SITES.items()},
                      **{(2, *s): n for s, n in DYNUNET_NORM_SITES.items()}}
# UNETR's, batch 4 of 96^3, float32
UNETR_F32_CONV_SITES = {(4, *s): n for s, n in UNETR_CONV_SITES.items()}
UNETR_F32_NORM_SITES = {(4, *s): n for s, n in UNETR_NORM_SITES.items()}


def test_the_steps_have_their_sites():
    assert sum(UNET_TRAIN_SITES.values()) == 10 and sum(UNET_NORM_SITES.values()) == 17
    assert sum(SEGRESNET_SITES.values()) == 25
    assert sum(DYNUNET_CONV_SITES.values()) == 17 and sum(DYNUNET_NORM_SITES.values()) == 22
    assert DYNUNET_CONV_SITES[(640, 320, (8, 8, 8))] == 1 and DYNUNET_CONV_SITES[(32, 32, (128, 128, 128))] == 2
    assert sum(UNETR_CONV_SITES.values()) == 16 and sum(UNETR_NORM_SITES.values()) == 21
    assert UNETR_CONV_SITES[(256, 128, (12, 12, 12))] == 1 and UNETR_CONV_SITES[(32, 16, (96, 96, 96))] == 1


def test_unetr_sites_are_a_small_unetrs():
    """``unetr_sites`` at feature size 4 and a 32^3 image is what hooks read off such a UNETR
    (hidden 32) on the CPU, as ``chip_smoke.record_sites`` reads them on the card."""
    net = UNETR(1, 3, 32, feature_size=4, hidden_size=32, mlp_dim=64, num_heads=4, proj_type="perceptron",
                norm_name="instance", device="cpu")
    convs, norms, hooks = {}, {}, []

    def count(table, key):
        table[key] = table.get(key, 0) + 1

    for m in net.modules():
        if isinstance(m, Conv3d) and m.same_3x3x3:
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: count(convs, (mod.in_channels, mod.out_channels, tuple(inp[0].shape[2:])))))
        elif isinstance(m, InstanceNorm):
            hooks.append(m.register_forward_hook(lambda mod, inp, out: count(norms, (
                out.shape[1], tuple(out.shape[2:]), mod.affine, round(float(inp[1]), 6) if len(inp) > 1 else None))))
    with torch.no_grad():
        net(torch.rand(1, 1, 32, 32, 32))
    for h in hooks:
        h.remove()
    assert (convs, norms) == unetr_sites(4, 32)


@pytest.mark.parametrize("batch,ci,co,spatial", sorted(NEW_F32_CONV_SITES))
def test_wgrad_plan_at_the_new_float32_sites(batch, ci, co, spatial):
    p = wgrad_plan((batch, *spatial, ci), co, torch.float32)
    assert p["route"] == ("small" if ci <= 2 and co <= 2 else "fma")
    assert p["smem"] <= BLOCK_SHARED and p["per_sm"] * (p["smem"] + 1024) <= SM_SHARED
    assert (p["tiles_ci"] - 1) * p["rc"] * p["pci"] < ci <= p["tiles_ci"] * p["rc"] * p["pci"]
    assert (p["tiles_co"] - 1) * p["ro"] * p["pco"] < co <= p["tiles_co"] * p["ro"] * p["pco"]
    assert p["bricks"] == batch * _cdiv(spatial[0], p["bd"]) * _cdiv(spatial[1], p["bh"]) * _cdiv(spatial[2], p["bw"])
    assert (p["chunks"] - 1) * p["per_chunk"] < p["bricks"] <= p["chunks"] * p["per_chunk"]


@pytest.mark.parametrize("batch,c,spatial", sorted({(b, c, sp) for b, c, sp, _, _ in NEW_F32_NORM_SITES}))
def test_norm_plans_at_the_new_float32_sites(batch, c, spatial):
    n = spatial[0] * spatial[1] * spatial[2]
    fwd = instance_norm_plan(batch, c, n, torch.float32)
    assert fwd["smem"] <= H100[1] and fwd["vec"] == 4
    units = batch * c // fwd["group"]
    if fwd["path"] == "onchip":
        assert fwd["blocks"] == units
    else:
        assert fwd["blocks"] == fwd["per_unit"] * fwd["units_per_group"] and fwd["unit_groups"] * fwd[
            "units_per_group"] >= units
    _check_invariants(instance_norm_backward_plan(batch, c, n, torch.float32), batch, c, n, torch.float32)


@pytest.mark.parametrize("batch,ci,co,spatial", sorted(UNETR_F32_CONV_SITES))
def test_wgrad_plan_at_the_unetr_sites(batch, ci, co, spatial):
    test_wgrad_plan_at_the_new_float32_sites(batch, ci, co, spatial)


@pytest.mark.parametrize("batch,c,spatial", sorted({(b, c, sp) for b, c, sp, _, _ in UNETR_F32_NORM_SITES}))
def test_norm_plans_at_the_unetr_sites(batch, c, spatial):
    test_norm_plans_at_the_new_float32_sites(batch, c, spatial)
