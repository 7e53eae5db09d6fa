"""The instance norm's backward plan (``instance_norm_backward_plan``), on the CPU.

``instance_norm_backward_plan`` makes on the host the plan that csrc/instance_norm.cu's
backward launches (tests/test_torch_cuda_kernels.py holds it equal to the card's on an
H100). Here it is held to what the kernel needs at every norm site of the two training
steps (the bench UNet's, bfloat16, and the BTCV SwinUNETR's, float32 and bfloat16; batch
4 of 96^3) and on a grid of small shapes: one launch; its shared memory within a block's
without lowering the modelled occupancy; a group's x and g within the stash and the L2
budget, or, where no group fits, the narrowest channel group with rows of a 128-byte
line, one unit a group. And a walk over its
units, blocks, threads and vectors in float64, as the kernel walks them (the stash, the
reverse order of dx, the partials added in block order), gives
``instance_norm_prelu_backward_plain``'s dx and sums to 1e-10 of max|ref|, the plain
version run in float64 (its float32 casts made float64 for the test).
"""
import math

import numpy as np
import pytest
import torch

from monai_tpu_torch.networks.layers import fast_norm
from monai_tpu_torch.networks.layers.fast_norm import (H100, _BWD_PATHS, _DTYPE_CODES, _L2_BUDGET, _bwd_smem_floats,
                                                      _model_occupancy, instance_norm_backward_plan,
                                                      instance_norm_prelu_backward_plain)

# (C, spatial, affine, slope): count, the instance norms of one training step at batch 4 of
# 96^3 (chip_smoke.py's record_sites on the full-width nets): the BTCV SwinUNETR's, affine,
# the LeakyReLU's 0.01 fused into each block's first norm; the bench UNet's, no affine,
# PReLU 0.25 fused into each
SWIN_NORM_SITES = {(48, (96, 96, 96), True, 0.01): 2, (48, (96, 96, 96), True, None): 4,
                   (48, (48, 48, 48), True, 0.01): 2, (48, (48, 48, 48), True, None): 3,
                   (96, (24, 24, 24), True, 0.01): 2, (96, (24, 24, 24), True, None): 3,
                   (192, (12, 12, 12), True, 0.01): 2, (192, (12, 12, 12), True, None): 3,
                   (384, (6, 6, 6), True, 0.01): 1, (384, (6, 6, 6), True, None): 2,
                   (768, (3, 3, 3), True, 0.01): 1, (768, (3, 3, 3), True, None): 1}
UNET_NORM_SITES = {(2, (96, 96, 96), False, 0.25): 1, (16, (48, 48, 48), False, 0.25): 4,
                   (32, (24, 24, 24), False, 0.25): 4, (64, (12, 12, 12), False, 0.25): 4,
                   (128, (6, 6, 6), False, 0.25): 2, (256, (6, 6, 6), False, 0.25): 2}
BATCH = 4
SM_SHARED = 233472  # an H100 SM's shared memory, 1 KB of it reserved a block
STEP_SITES = sorted({(torch.bfloat16, c, sp) for c, sp, _, _ in UNET_NORM_SITES}
                    | {(dt, c, sp) for dt in (torch.float32, torch.bfloat16) for c, sp, _, _ in SWIN_NORM_SITES},
                    key=str)


def _cdiv(a, b):
    return -(-a // b)


def _rows(channels, spatial, dtype, aligned):
    """The channel groups the backward's persistent grid may take: the vectors' groups
    with rows of a 128-byte line at least, or all the channels, or the widest."""
    elem, _, groups = fast_norm._vectors(channels, spatial, dtype, aligned)
    rows = [g for g in groups if g * elem >= 32 or g == channels]
    return [g for g in rows if g * elem >= 128 or g == channels or g == rows[-1]]


def _check_invariants(p, batch, channels, spatial, dtype, aligned=True, card=H100, forced=False):
    elem = torch.empty((), dtype=dtype).element_size()
    assert p["launches"] == 1
    assert p["group"] * elem >= 32 or p["group"] == channels
    assert p["smem"] <= card[1]
    units = batch * channels // p["group"]
    base = 16 * _cdiv(_bwd_smem_floats(p["threads"], p["vec"], p["group"]), 4)
    if p["path"] == "onchip":
        assert p["blocks"] == p["units_per_group"] == units and p["unit_groups"] == 1
        assert p["smem"] == 2 * spatial * p["group"] * elem + base
        return
    if not forced:
        assert p["group"] in _rows(channels, spatial, dtype, aligned)
    assert (p["vec"] == 1) == (p["path"] == "general")
    code = _DTYPE_CODES[dtype], _BWD_PATHS[p["path"]], p["vec"], p["threads"]
    # the stash takes no more than a block may without lowering the modelled occupancy
    assert _model_occupancy(*code, base) == _model_occupancy(*code, p["smem"]) == p["per_sm"]
    room = min((card[1] + 1024) // p["per_sm"] - 1024, card[1]) - base
    cap = room // (32 * p["threads"]) if p["vec"] > 1 else 0
    assert p["smem"] == base + 32 * p["stash"] * p["threads"] and p["stash"] <= cap
    assert p["blocks"] == p["per_unit"] * p["units_per_group"] <= card[0] * p["per_sm"]
    assert p["unit_groups"] == _cdiv(units, p["units_per_group"])
    # a group's x and g within the stash over the grid and the L2 budget, or, where no
    # channel group's unit fits, the narrowest group, one unit at a time
    assert p["held_bytes"] == card[0] * p["per_sm"] * cap * p["threads"] * 32 + fast_norm._L2_BUDGET
    assert p["group_bytes"] == p["units_per_group"] * 2 * spatial * p["group"] * elem
    if p["group_bytes"] > p["held_bytes"] and not forced:
        assert p["units_per_group"] == 1 and p["group"] == min(_rows(channels, spatial, dtype, aligned))


def test_the_steps_have_their_sites():
    assert sum(SWIN_NORM_SITES.values()) == 26 and sum(UNET_NORM_SITES.values()) == 17


@pytest.mark.parametrize("dtype,c,spatial", STEP_SITES)
def test_plan_at_the_step_sites(dtype, c, spatial):
    s = math.prod(spatial)
    for aligned in (True, False):
        p = instance_norm_backward_plan(BATCH, c, s, dtype, aligned)
        _check_invariants(p, BATCH, c, s, dtype, aligned)
        if not aligned:
            assert p["path"] == "general"


def test_the_widest_sites_take_whole_rows():
    """At (4, 48, 96^3) no channel group's x and g with rows of a 128-byte line fit the stash
    and the L2 budget: a whole instance a unit, one a group; the (4, 48, 48^3) instance fits
    whole, the (4, 96, 24^3) site in one group; 12^3 and below on chip."""
    for dtype in (torch.float32, torch.bfloat16):
        p = instance_norm_backward_plan(BATCH, 48, 96 ** 3, dtype)
        assert (p["path"], p["group"], p["units_per_group"], p["unit_groups"]) == ("persistent", 48, 1, 4)
        assert p["unit_bytes"] > 3 * p["held_bytes"]
    assert instance_norm_backward_plan(BATCH, 48, 48 ** 3, torch.float32)["group"] == 48
    mid = instance_norm_backward_plan(BATCH, 96, 24 ** 3, torch.float32)
    assert (mid["group"], mid["unit_groups"]) == (96, 1)
    for c, n in ((192, 12), (384, 6), (768, 3)):
        assert instance_norm_backward_plan(BATCH, c, n ** 3, torch.float32)["path"] == "onchip"
    for c, sp, _, _ in UNET_NORM_SITES:  # the UNet's persistent sites in one group each
        p = instance_norm_backward_plan(BATCH, c, math.prod(sp), torch.bfloat16)
        assert p["path"] == "onchip" or p["unit_groups"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_plan_on_a_grid_of_shapes(dtype):
    for batch in (1, 3):
        for c in (1, 2, 3, 4, 7, 8, 16, 24, 48, 64, 96, 256, 768):
            for spatial in ((5, 6, 7), (3, 3, 3), (24, 24, 24), (40, 40, 40), (64, 64, 64)):
                s = math.prod(spatial)
                for aligned in (True, False):
                    p = instance_norm_backward_plan(batch, c, s, dtype, aligned)
                    _check_invariants(p, batch, c, s, dtype, aligned)


def test_forced_groups_and_refusals():
    p = instance_norm_backward_plan(BATCH, 48, 96 ** 3, torch.float32, group=24)
    assert (p["group"], p["unit_groups"]) == (24, 8)
    with pytest.raises(ValueError):
        instance_norm_backward_plan(BATCH, 48, 96 ** 3, torch.bfloat16, group=4)  # no 16-byte vector of 4
    with pytest.raises(TypeError):
        instance_norm_backward_plan(BATCH, 48, 8, torch.float64)


def _walk(g, x, stats, w, b, a, p):
    """dx and the sums as the kernel computes them under plan p, in float64: for each unit,
    each block's threads over their vectors (the first ``stash`` of each kept in the stash),
    the lanes folded per channel into the block's partials, the partials added in block
    order; then dx, each thread's vectors in the reverse of the sums' order. Checks that
    every element is summed once and written once, and what the stash holds fits it."""
    bsz, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    xs = x.double().permute(0, *range(2, x.ndim), 1).reshape(-1).numpy()
    gs = g.double().permute(0, *range(2, x.ndim), 1).reshape(-1).numpy()
    st = stats.double().numpy()
    ww = np.ones(c) if w is None else w.double().numpy()
    bb = np.zeros(c) if b is None else b.double().numpy()
    aa = None if a is None else np.broadcast_to(a.double().numpy(), (c,))
    vec, grp, threads, per_unit = p["vec"], p["group"], p["threads"], p["per_unit"]
    gv = p["phases"]
    rowstride = gv * vec if grp == c else c
    nvec, units = s * grp // vec, bsz * (c // grp)
    upg = units if p["path"] == "onchip" else p["units_per_group"]
    stride = per_unit * threads
    dx = np.full(xs.shape, np.nan)
    summed, written = np.zeros(xs.shape, int), np.zeros(xs.shape, int)
    sums = np.zeros((3, bsz, c))
    t = np.arange(threads)
    k = t % gv
    lanes = np.arange(vec)
    seen = []
    for ug in range(_cdiv(units, upg)):
        for slot in range(upg):
            u = ug * upg + slot
            if u >= units:
                continue
            seen.append(u)
            bi, c0 = u // (c // grp), (u % (c // grp)) * grp
            chan = c0 + (k[:, None] * vec + lanes[None, :]) % grp  # (thread, lane)
            m, r = st[0, bi][chan], st[1, bi][chan]
            sc, sh = r * ww[chan], bb[chan]
            blocks = []
            partials = np.zeros((per_unit, 3, grp))
            for jb in range(per_unit):
                i0 = jb * threads + t
                n_it = np.where(i0 < nvec, (nvec - 1 - np.minimum(i0, nvec - 1)) // stride + 1, 0)
                n_st = np.minimum(n_it, p["stash"])  # the vectors of x and of g each thread stashes
                assert p["path"] == "onchip" or p["stash"] * 32 * threads <= p["stash_bytes"]
                its = np.arange(n_it.max(initial=0))
                valid = its[:, None] < n_it[None, :]  # (it, thread)
                i = i0[None, :] + its[:, None] * stride
                offs = bi * s * c + c0 + (i // gv)[..., None] * rowstride + k[None, :, None] * vec + lanes
                offs = np.where(valid[..., None], offs, 0)
                xv, gvv = xs[offs], gs[offs]
                xh = (xv - m) * r
                z = (xv - m) * sc + sh
                neg = (z < 0) & (aa is not None)
                gz = np.where(neg, gvv * (aa[chan] if aa is not None else 1.0), gvv)
                terms = np.stack((gz, gz * xh, np.where(neg, gvv * z, 0.0)))  # (3, it, thread, lane)
                terms = np.where(valid[None, ..., None], terms, 0.0)
                np.add.at(summed, offs[valid], 1)
                lane_sums = terms.sum(1)  # each thread's lanes, over its vectors
                for q in range(3):
                    np.add.at(partials[jb, q], (chan - c0).reshape(-1), lane_sums[q].reshape(-1))
                blocks.append((offs, valid, xh, gz, n_it, n_st))
            tot = np.zeros((3, grp))
            for jb in range(per_unit):  # the partials in block order
                tot += partials[jb]
            sums[:, bi, c0:c0 + grp] = tot
            mg, mgx = tot[0][chan - c0] / s, tot[1][chan - c0] / s
            for offs, valid, xh, gz, n_it, n_st in blocks:
                for it in reversed(range(offs.shape[0])):  # global vectors first, then the stash
                    on = valid[it]
                    if not on.any():
                        continue
                    o = offs[it][on]
                    assert (written[o] == 0).all()
                    written[o] += 1
                    dx[o] = (sc * (gz[it] - mg - xh[it] * mgx))[on]
    assert sorted(seen) == list(range(units)) and (summed == 1).all() and (written == 1).all()
    dx = torch.from_numpy(dx).view(bsz, *x.shape[2:], c).permute(0, x.ndim - 1, *range(1, x.ndim - 1))
    return dx, torch.from_numpy(sums)


# (plan dtype, shape, aligned, card, L2 budget, group, path): each path; small cards and
# budgets give several blocks a unit, several groups of units (the last one part empty)
# and a stash that holds part of a thread's vectors
WALKS = [(torch.float32, (2, 1, 16, 16, 8), True, H100, _L2_BUDGET, None, "onchip"),  # four voxels a vector
         (torch.float32, (2, 2, 16, 16, 16), True, H100, _L2_BUDGET, None, "onchip"),
         (torch.float32, (3, 24, 8, 8, 8), True, H100, _L2_BUDGET, None, "onchip"),
         (torch.bfloat16, (2, 48, 8, 8, 4), True, H100, _L2_BUDGET, None, "onchip"),
         (torch.float32, (3, 48, 16, 16, 8), True, (6, 40960), 1 << 20, None, "persistent"),  # a whole instance a unit
         (torch.float32, (2, 48, 32, 16, 16), True, (6, 40960), 1 << 12, 8, "persistent"),  # 8 channels a unit
         (torch.float32, (2, 48, 32, 16, 16), True, (6, 40960), 1 << 12, 16, "persistent"),
         (torch.bfloat16, (3, 24, 16, 16, 8), True, (5, 49152), 1 << 12, None, "persistent"),
         (torch.bfloat16, (5, 24, 16, 16, 8), True, (6, 49152), 1 << 19, None, "persistent"),  # 3 units a group
         (torch.float32, (3, 1, 32, 32, 16), True, (4, 40960), 1 << 12, None, "persistent"),  # whole voxels a vector
         (torch.bfloat16, (2, 2, 32, 32, 16), True, (4, 49152), 1 << 12, None, "persistent"),
         (torch.float32, (2, 3, 10, 9, 7), True, (3, 40960), 1 << 10, None, "general"),  # C = 3
         (torch.float16, (3, 24, 9, 7, 5), False, (2, 40960), 1 << 10, None, "general")]  # unaligned


@pytest.mark.parametrize("dtype,shape,aligned,card,budget,group,path", WALKS)
@pytest.mark.parametrize("slope", [None, "one"])
def test_walk_over_the_plan_gives_the_backward(monkeypatch, dtype, shape, aligned, card, budget, group, path, slope):
    s = math.prod(shape[2:])
    monkeypatch.setattr(fast_norm, "_L2_BUDGET", budget)
    instance_norm_backward_plan.cache_clear()
    try:
        p = instance_norm_backward_plan(shape[0], shape[1], s, dtype, aligned, card, group=group)
        _check_invariants(p, shape[0], shape[1], s, dtype, aligned, card, forced=group is not None)
    finally:
        instance_norm_backward_plan.cache_clear()
    assert p["path"] == path and (path == "onchip" or p["per_unit"] > 1 and p["unit_groups"] > 1)
    gen = torch.Generator().manual_seed(shape[1] * 7 + shape[0])
    c = shape[1]
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * 2 + 0.5
    g = torch.randn(shape, generator=gen, dtype=torch.float64)
    stats = torch.stack((torch.randn(shape[:2], generator=gen, dtype=torch.float64) * 0.3 + 0.5,
                         torch.rand(shape[:2], generator=gen, dtype=torch.float64) + 0.5))
    w = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn(c, generator=gen, dtype=torch.float64)
    a = None if slope is None else torch.full((1,), 0.25, dtype=torch.float64)
    got_dx, got_sums = _walk(g, x, stats, w, b, a, p)
    with monkeypatch.context() as mp:  # the plain version's own arithmetic, in float64
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        ref_dx, ref_sums = instance_norm_prelu_backward_plain(g, x, stats, w, b, a)
    assert ref_dx.dtype == torch.float64
    assert (got_dx - ref_dx).abs().max().item() <= 1e-10 * ref_dx.abs().max().item()
    for s_, r_ in zip(got_sums, ref_sums.double()):
        assert (s_ - r_).abs().max().item() <= 1e-10 * max(r_.abs().max().item(), 1e-30)
