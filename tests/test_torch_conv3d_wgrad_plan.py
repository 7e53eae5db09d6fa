"""The conv's weight-gradient plan (``wgrad_plan``), on the CPU.

``wgrad_plan`` makes on the host the plan that csrc/conv3d_3x3_wgrad.cu makes on the card:
the route, the brick, the tiles, the register tile, the threads, the shared memory and the
K chunks (tests/test_torch_cuda_kernels.py holds the two equal on the card). Here it is
held to what the kernel needs at every site of the two training steps (the bench UNet's,
bfloat16, and the BTCV SwinUNETR's, float32 and bfloat16; batch 4 of 96^3) and of the
BraTS and Spleen bundles' float32 steps (batch 1 and 8): its shared
memory fits a block, its tiles cover CI and CO, its chunks cover every brick once, in
order. And a walk over its bricks, halos and chunks in float64, as the kernel walks them,
gives ``conv3d_3x3_wgrad_plain``'s result to 1e-10 of max|ref| (float64 sums in another
order) at small ragged shapes.
"""
import itertools

import pytest
import torch
import torch.nn.functional as F

from monai_tpu_torch.ops.conv3d import conv3d_3x3_wgrad_plain, wgrad_plan

# (CI, CO, spatial): count, the 3x3x3 stride-1 convs of one training step at batch 4 of
# 96^3 (chip_smoke.py's record_sites on the full-width nets)
UNET_TRAIN_SITES = {(2, 2, (96, 96, 96)): 1, (16, 16, (48, 48, 48)): 2, (32, 32, (24, 24, 24)): 2,
                    (64, 64, (12, 12, 12)): 2, (128, 128, (6, 6, 6)): 1, (128, 256, (6, 6, 6)): 1,
                    (256, 256, (6, 6, 6)): 1}
SWIN_TRAIN_SITES = {(1, 48, (96, 96, 96)): 1, (48, 48, (96, 96, 96)): 2, (96, 48, (96, 96, 96)): 1,
                    (48, 48, (48, 48, 48)): 3, (96, 48, (48, 48, 48)): 1, (96, 96, (24, 24, 24)): 3,
                    (192, 96, (24, 24, 24)): 1, (192, 192, (12, 12, 12)): 3, (384, 192, (12, 12, 12)): 1,
                    (384, 384, (6, 6, 6)): 1, (768, 384, (6, 6, 6)): 1, (768, 768, (3, 3, 3)): 2}
# the float32 training steps of the BraTS bundle's SegResNet (batch 1) and of the Spleen
# bundle's batch-norm UNet (batch 8), as (batch, CI, CO, spatial): count
F32_BUNDLE_SITES = {(1, 1, 16, (96, 96, 96)): 1, (1, 16, 16, (96, 96, 96)): 4, (1, 32, 32, (48, 48, 48)): 6,
                    (1, 64, 64, (24, 24, 24)): 6, (1, 128, 128, (12, 12, 12)): 8,
                    **{(8, *site): n for site, n in UNET_TRAIN_SITES.items()}}
# (dtype, CI, CO, spatial) of both steps: the UNet's in bfloat16, the Swin's in the step's
# float32 and in bfloat16 (chip_smoke.py phase 9 checks both)
STEP_SITES = ([(torch.bfloat16, *s) for s in UNET_TRAIN_SITES]
              + [(dt, *s) for dt in (torch.float32, torch.bfloat16) for s in SWIN_TRAIN_SITES])
BATCH = 4
SM_SHARED, BLOCK_SHARED = 233472, 232448  # an H100 SM's shared memory and a block's most


def _cdiv(a, b):
    return -(-a // b)


def test_the_steps_have_their_sites():
    assert sum(UNET_TRAIN_SITES.values()) == 10 and sum(SWIN_TRAIN_SITES.values()) == 20
    assert sum(n for (b, *_), n in F32_BUNDLE_SITES.items() if b == 1) == 25  # SegResNet's 3x3x3 convs


@pytest.mark.parametrize("batch,ci,co,spatial", sorted(F32_BUNDLE_SITES))
def test_plan_at_the_float32_bundle_sites(batch, ci, co, spatial):
    """At each float32 site of the two bundles' steps: the FMA route (the small one at 2 -> 2),
    one block's shared memory, tiles that cover CI and CO, chunks that cover every brick."""
    p = wgrad_plan((batch, *spatial, ci), co, torch.float32)
    assert p["route"] == ("small" if ci <= 2 and co <= 2 else "fma")
    assert p["smem"] <= BLOCK_SHARED and p["per_sm"] * (p["smem"] + 1024) <= SM_SHARED
    assert (p["tiles_ci"] - 1) * p["rc"] * p["pci"] < ci <= p["tiles_ci"] * p["rc"] * p["pci"]
    assert (p["tiles_co"] - 1) * p["ro"] * p["pco"] < co <= p["tiles_co"] * p["ro"] * p["pco"]
    assert p["bricks"] == batch * _cdiv(spatial[0], p["bd"]) * _cdiv(spatial[1], p["bh"]) * _cdiv(spatial[2], p["bw"])
    assert (p["chunks"] - 1) * p["per_chunk"] < p["bricks"] <= p["chunks"] * p["per_chunk"]


@pytest.mark.parametrize("dtype,ci,co,spatial", STEP_SITES)
def test_plan_at_the_step_sites(dtype, ci, co, spatial):
    p = wgrad_plan((BATCH, *spatial, ci), co, dtype)
    assert p["route"] == ("mma" if dtype != torch.float32 and ci % 8 == 0 and co % 8 == 0 else
                          "small" if ci <= 2 and co <= 2 else "fma")
    assert p["smem"] <= BLOCK_SHARED and p["per_sm"] * (p["smem"] + 1024) <= SM_SHARED
    if p["route"] == "fma":  # nine (kd, kh) rows of channel groups, split over lines
        assert p["threads"] == 9 * p["pci"] * p["pco"] * p["splits"] <= 432 and p["rc"] * p["ro"] <= 16
    # the tiles cover CI and CO, the last one partly at most
    ci_tile, co_tile = p["rc"] * p["pci"], p["ro"] * p["pco"]
    assert (p["tiles_ci"] - 1) * ci_tile < ci <= p["tiles_ci"] * ci_tile
    assert (p["tiles_co"] - 1) * co_tile < co <= p["tiles_co"] * co_tile
    # the bricks cover the volume; the chunks cover every brick once, in order
    assert p["bricks"] == BATCH * _cdiv(spatial[0], p["bd"]) * _cdiv(spatial[1], p["bh"]) * _cdiv(spatial[2], p["bw"])
    assert (p["chunks"] - 1) * p["per_chunk"] < p["bricks"] <= p["chunks"] * p["per_chunk"]
    assert p["blocks"] == p["tiles_ci"] * p["tiles_co"] * p["chunks"]
    assert p["partial"] == (p["chunks"] * 27 * ci * co if p["chunks"] > 1 else 0)
    assert p["launches"] == (2 if p["chunks"] > 1 else 1)


def test_the_float32_swin_sites_take_the_wide_fma_tile():
    """At every float32 Swin site from 48 channels on: 4 x 4 registers a thread, a CO tile of
    48, a CI tile of 16, nine (kd, kh) rows of 48 channel groups; lines of 32 at 96^3."""
    for ci, co, spatial in SWIN_TRAIN_SITES:
        p = wgrad_plan((BATCH, *spatial, ci), co, torch.float32)
        if ci >= 48:
            assert (p["rc"], p["ro"], p["pci"], p["pco"], p["splits"], p["threads"]) == (4, 4, 4, 12, 1, 432)
        if spatial[0] == 96:
            assert p["bw"] == 32 and p["chunks"] > 1


@pytest.mark.parametrize("sms,resident", [(132, 2), (114, 1)])
@pytest.mark.parametrize("ci,co,spatial", [(48, 48, (96, 96, 96)), (192, 192, (12, 12, 12)), (768, 768, (3, 3, 3))])
def test_chunks_take_the_fewest_waves(sms, resident, ci, co, spatial):
    """The chunks fill the card's blocks (SMs x resident) in the fewest waves times the bricks
    of a chunk and one more (a block's fixed cost), the fewest chunks of those: at 192 -> 192
    12^3, 5 chunks of 48 tiles (one wave of 240 blocks) rather than 6 (288 blocks, a second
    wave of 24)."""
    p = wgrad_plan((BATCH, *spatial, ci), co, torch.float32, sms=sms, resident=resident)
    slots, tiles = sms * resident, p["tiles_ci"] * p["tiles_co"]

    def cost(c):
        return _cdiv(tiles * c, slots) * (_cdiv(p["bricks"], c) + 1)

    assert p["per_sm"] == resident
    assert all(cost(p["chunks"]) <= cost(c) for c in range(1, min(p["bricks"], 4 * _cdiv(slots, tiles)) + 1))
    assert all(cost(c) > cost(p["chunks"]) for c in range(1, p["chunks"]))
    if (ci, sms) == (192, 132):
        assert (p["chunks"], p["blocks"]) == (5, 240)


@pytest.mark.parametrize("dtype,aligned", [(torch.bfloat16, False), (torch.float16, True), (torch.float32, True)])
def test_routes_of_the_other_cases(dtype, aligned):
    """Unaligned 16-bit tensors and channels not a multiple of 8 take the fma route; 1 and 2
    channels the small route in every type."""
    assert wgrad_plan((1, 4, 5, 6, 16), 16, dtype, aligned)["route"] == ("mma" if aligned and dtype != torch.float32
                                                                          else "fma")
    assert wgrad_plan((1, 4, 5, 6, 12), 16, dtype, aligned)["route"] == "fma"
    assert wgrad_plan((1, 4, 5, 6, 2), 1, dtype, aligned)["route"] == "small"


def _walk(x: torch.Tensor, g: torch.Tensor, p: dict) -> torch.Tensor:
    """dw as the kernel sums it, in float64: each chunk's partials over its bricks (each
    brick's halo of x against its rows of g, zero past the volume), then the chunks in
    order."""
    n, d, h, w, ci = x.shape
    co = g.shape[-1]
    bd, bh, bw = p["bd"], p["bh"], p["bw"]
    nb = (_cdiv(d, bd), _cdiv(h, bh), _cdiv(w, bw))
    # x with a zero halo of 1 before and bd + 1 (bh + 1, bw + 1) after, g with bd (bh, bw)
    # zeros after, so that a brick past the volume reads zeros
    xp = F.pad(x.double(), (0, 0, 1, bw + 1, 1, bh + 1, 1, bd + 1))
    gp = F.pad(g.double(), (0, 0, 0, bw, 0, bh, 0, bd))
    total = torch.zeros((27, ci, co), dtype=torch.float64)
    for c in range(p["chunks"]):
        b0, b1 = c * p["per_chunk"], min((c + 1) * p["per_chunk"], p["bricks"])
        assert b0 < b1
        part = torch.zeros((27, ci, co), dtype=torch.float64)
        for b in range(b0, b1):
            iw, ih, idd, i = b % nb[2], b // nb[2] % nb[1], b // (nb[2] * nb[1]) % nb[0], b // (nb[2] * nb[1] * nb[0])
            d0, h0, w0 = idd * bd, ih * bh, iw * bw
            halo = xp[i, d0:d0 + bd + 2, h0:h0 + bh + 2, w0:w0 + bw + 2]
            rows = gp[i, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw].reshape(-1, co)
            for t, (kd, kh, kw) in enumerate(itertools.product(range(3), repeat=3)):
                part[t] += halo[kd:kd + bd, kh:kh + bh, kw:kw + bw].reshape(-1, ci).T @ rows
        total += part
    return total.reshape(3, 3, 3, ci, co)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co", [(1, 1), (2, 2), (1, 48), (3, 2), (48, 3), (2, 48), (48, 48)])
@pytest.mark.parametrize("shape", [(2, 3, 7, 37), (1, 10, 5, 33)])
def test_walk_over_the_plan_gives_the_correlation(dtype, ci, co, shape):
    """Spatial sizes no brick divides (lines of 37 and 33 split into 19/18 and 17/16); a few
    chunks (24 SMs of 1 block), so that the last chunk may hold fewer bricks."""
    gen = torch.Generator().manual_seed(ci * 100 + co)
    x = torch.randn((*shape, ci), generator=gen, dtype=torch.float64)
    g = torch.randn((*shape, co), generator=gen, dtype=torch.float64)
    p = wgrad_plan(x.shape, co, dtype, sms=24, resident=1)
    assert p["chunks"] > 1
    got = _walk(x, g, p)
    ref = conv3d_3x3_wgrad_plain(x, g)
    assert ref.dtype == torch.float64
    assert (got - ref).abs().max().item() <= 1e-10 * ref.abs().max().item()
