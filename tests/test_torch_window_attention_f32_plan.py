"""The float32 forward's plan (``attention_fwd_plan``) and its arithmetic, on the CPU.

``attention_fwd_plan`` makes on the host the plan that csrc/window_attention.cu makes on the
card for its float32 tensor-core instance ("tf32x3"): the query rows of a block, the windows
it walks over, the blocks, the blocks an SM and the shared memory
(tests/test_torch_cuda_kernels.py holds the two equal on the card). Here it is held to its
invariants at every attention site of the float32 SwinUNETR step (chip_smoke.py phase 9)
and their head-dim-8 twins: the shared memory fits a block, and every (window, head, query
row) belongs to exactly one block.

And the kernel's arithmetic is walked over the plan in float64, lane by lane, as the kernel
computes it: each block's windows, row groups and the warps' parts of the keys, chunks of 8
keys; the lanes' fragments of q and k (the head dims each lane supplies to a k8 step), of
the exps (S's accumulator taken as the A fragment of E V, A's column t as key 2t and column
t + 4 as key 2t + 1) and of v (the rows of keys 2t and 2t + 1) assembled by the m16n8k8
layouts; every product in 3xTF32 (big = x & 0xffffe000, small = (x - big) & 0xffffe000,
big.big + big.small + small.big); E V scaled by 1/sum at the end. The output and the
log-sum-exp agree with ``fused_window_attention_plain`` within the float32 gate, 1e-4 of
max|ref|; a wrong fragment or key order would not.
"""
import pytest
import torch

from chip_smoke import SWIN_ATTN_SITES
from monai_tpu_torch.ops.window_attention import attention_fwd_plan, fused_window_attention_plain

BLOCK_SHARED, SM_SHARED = 232448, 233472  # an H100 block's most shared memory, an SM's
STEP_D8_SITES = [(b, h, n, 8, nw) for (b, h, n, _, nw) in SWIN_ATTN_SITES]
TOL_F32 = 1e-4

LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4  # a lane's group (row of A, column of B) and thread in the group


def _cdiv(a, b):
    return -(-a // b)


def _blocks(p, b, h, n, nw):
    """(query tile, head, windows in walk order) of each block, in the kernel's block order."""
    nw = nw or 1
    per_row, wb, rows = b // nw, p["windows_per_block"], p["rows_per_block"]
    splits = _cdiv(per_row, wb)
    for blk in range(p["blocks"]):
        qt, rest = blk % _cdiv(n, rows), blk // _cdiv(n, rows)
        hh, rest = rest % h, rest // h
        split, w = rest % splits, rest // splits
        j0 = split * wb
        yield qt, hh, [w + nw * j for j in range(j0, min(per_row, j0 + wb))]


@pytest.mark.parametrize("b,h,n,d,nw", list(SWIN_ATTN_SITES) + STEP_D8_SITES)
def test_plan_at_the_step_sites(b, h, n, d, nw):
    p = attention_fwd_plan(b, h, n, d, nw or 0)
    assert p["instance"] == "tf32x3" and p["smem_bytes"] <= BLOCK_SHARED
    assert p["blocks_per_sm"] * (p["smem_bytes"] + 1024) <= SM_SHARED
    # 64 rows, K and V double-buffered, one block of 8 warps an SM
    assert (p["rows_per_block"], p["stages"], p["blocks_per_sm"]) == (64, 2, 1)
    owned = torch.zeros((b, h, n), dtype=torch.int32)
    rows = p["rows_per_block"]
    for qt, hh, windows in _blocks(p, b, h, n, nw):
        assert windows and all(w % (nw or 1) == windows[0] % (nw or 1) for w in windows)  # one mask row
        owned[windows, hh, qt * rows:(qt + 1) * rows] += 1
    assert bool((owned == 1).all())


def test_plan_shrinks_the_tile_where_shared_memory_runs_out():
    """At N = 512, D = 32 a 64-row addend tile does not fit beside K and V: 16 rows, one
    buffer; at N = 343, D = 32, 64 rows and one buffer."""
    p = attention_fwd_plan(12, 3, 512, 32, 4)
    assert (p["rows_per_block"], p["stages"]) == (16, 1) and p["smem_bytes"] <= BLOCK_SHARED
    p = attention_fwd_plan(12, 3, 343, 32, 0)
    assert (p["rows_per_block"], p["stages"]) == (64, 1)


def test_refused_shapes():
    for args in ((2, 1, 27, 12, 0), (2, 1, 729, 8, 0), (6, 1, 27, 8, 4)):
        with pytest.raises(ValueError):
            attention_fwd_plan(*args)


def _elems(d):
    """(32, D / 4): the head dims each lane supplies from a row of q or k, in the order of
    the k8 steps (step kk takes elements 2 kk and 2 kk + 1)."""
    t = T[:, None]
    if d == 8:
        return torch.cat([2 * t, 2 * t + 1], 1)
    return torch.cat([16 * u + 4 * t + i for u in range(d // 16) for i in range(4)], 1)


def _split(x):
    """A float32-valued float64 tensor as its 3xTF32 big and small parts."""
    def tf32(v):
        return (v.to(torch.float32).view(torch.int32) & -8192).view(torch.float32).double()  # & 0xffffe000
    big = tf32(x)
    return big, tf32(x.to(torch.float32).double() - big)


def _mma(a, b):
    """m16n8k8: the lanes' A (32, 4) and B (32, 2) registers, assembled by the PTX layouts,
    multiplied; the product in the lanes' C registers (32, 4)."""
    am = torch.zeros((16, 8), dtype=torch.float64)
    am[G, T], am[G + 8, T], am[G, T + 4], am[G + 8, T + 4] = a.unbind(1)
    bm = torch.zeros((8, 8), dtype=torch.float64)
    bm[T, G], bm[T + 4, G] = b.unbind(1)
    c = am @ bm
    return torch.stack([c[G, 2 * T], c[G, 2 * T + 1], c[G + 8, 2 * T], c[G + 8, 2 * T + 1]], 1)


def _mma3(a, b):
    (ab, asm), (bb, bs) = _split(a), _split(b)
    return _mma(ab, bb) + _mma(asm, bb) + _mma(ab, bs)


def _walk(q, k, v, bias, mask, p):
    """The output and the log-sum-exp as the kernel computes them, in float64."""
    b, h, n, d = q.shape
    nw = 0 if mask is None else mask.shape[0]
    q, k, v, bias = (t.double() for t in (q, k, v, bias))
    mask = None if mask is None else mask.double()
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, n), float("nan"), dtype=torch.float64)
    rows, keys = p["rows_per_block"], _cdiv(n, 8) * 8
    nc = keys // 8
    e = _elems(d)
    zero_k = torch.zeros((keys - n, d), dtype=torch.float64)
    for qt, hh, windows in _blocks(p, b, h, n, nw):
        q0 = qt * rows
        add = torch.full((rows, keys), float("-inf"), dtype=torch.float64)  # the addend tile
        add[:, :n] = 0.0
        live_rows = min(rows, n - q0)
        add[:live_rows, :n] = bias[hh, q0:q0 + live_rows] + (0 if mask is None else mask[windows[0] % nw,
                                                                                            q0:q0 + live_rows])
        for w in windows:
            kw, vw = torch.cat([k[w, hh], zero_k]), torch.cat([v[w, hh], zero_k])  # zero-filled past N
            for r0 in range(0, rows, 16):
                if q0 + r0 >= n:
                    continue
                ra, rb = q0 + r0 + G, q0 + r0 + G + 8
                qa = torch.where((ra < n)[:, None], q[w, hh, ra.clamp(max=n - 1)][LANE[:, None], e], 0.0)
                qb = torch.where((rb < n)[:, None], q[w, hh, rb.clamp(max=n - 1)][LANE[:, None], e], 0.0)
                parts = []
                ks, base_nc, extra = p["key_splits"], nc // p["key_splits"], nc % p["key_splits"]
                for part in range(ks):  # the first nc % ks warps of the group take one chunk more
                    c_begin, my_nc = part * base_nc + min(part, extra), base_nc + (part < extra)
                    s = []
                    for c in range(c_begin, c_begin + my_nc):
                        key0 = 8 * c
                        acc = torch.stack([add[r0 + G, key0 + 2 * T], add[r0 + G, key0 + 2 * T + 1],
                                           add[r0 + G + 8, key0 + 2 * T], add[r0 + G + 8, key0 + 2 * T + 1]], 1)
                        kr = kw[key0 + G][LANE[:, None], e]
                        for kk in range(d // 8):
                            a = torch.stack([qa[:, 2 * kk], qb[:, 2 * kk], qa[:, 2 * kk + 1], qb[:, 2 * kk + 1]], 1)
                            acc = acc + _mma3(a, kr[:, 2 * kk:2 * kk + 2])
                        s.append((key0, acc))
                    parts.append(s)
                # the row max over the group's warps (rows g and g + 8 of each quad)
                every = [acc for part in parts for _, acc in part]
                ma = torch.stack([x[:, :2] for x in every], 0).amax((0, 2)).view(8, 4).amax(1)[G]
                mb = torch.stack([x[:, 2:] for x in every], 0).amax((0, 2)).view(8, 4).amax(1)[G]
                ex = [(key0, torch.exp2((acc - torch.stack([ma, ma, mb, mb], 1)) * 1.4426950408889634))
                      for part in parts for key0, acc in part]
                sa = sum(x[:, :2].sum(1) for _, x in ex).view(8, 4).sum(1)[G]
                sb = sum(x[:, 2:].sum(1) for _, x in ex).view(8, 4).sum(1)[G]
                # E V, then scaled by 1/sum
                o = torch.zeros((32, d // 8, 4), dtype=torch.float64)
                for key0, x in ex:
                    a = x[:, [0, 2, 1, 3]]  # S's accumulator as P's A fragment
                    for nt in range(d // 8):
                        bv = torch.stack([vw[key0 + 2 * T, nt * 8 + G], vw[key0 + 2 * T + 1, nt * 8 + G]], 1)
                        o[:, nt] += _mma3(a, bv)
                o[..., :2] /= sa[:, None, None]
                o[..., 2:] /= sb[:, None, None]
                for nt in range(d // 8):
                    col = nt * 8 + 2 * T
                    for reg, row in ((0, ra), (2, rb)):
                        ok = row < n
                        out[w, hh, row[ok], col[ok]] = o[ok, nt, reg]
                        out[w, hh, row[ok], col[ok] + 1] = o[ok, nt, reg + 1]
                lse[w, hh, ra[ra < n]] = (ma + torch.log(sa))[ra < n]
                lse[w, hh, rb[rb < n]] = (mb + torch.log(sb))[rb < n]
    return out, lse


@pytest.mark.parametrize("b,h,n,d,nw,sms", [
    (6, 2, 27, 8, 3, 4),     # masked; 4 chunks, one a warp
    (4, 1, 100, 16, 0, 2),   # no mask; 13 chunks, 4, 3, 3, 3
    (2, 1, 216, 32, 2, 132), # a 6^3 window, D = 32: two warps a group, 14 and 13 chunks
    (1, 1, 343, 16, 0, 132), # a 7^3 window: 43 chunks, 11, 11, 11, 10
    (1, 1, 512, 8, 0, 132),  # 64 chunks, two warps a group, 32 each
])
def test_walk_over_the_plan_gives_the_forward(b, h, n, d, nw, sms):
    gen = torch.Generator().manual_seed(b * 100 + n + d)
    q, k, v = (torch.randn((b, h, n, d), generator=gen) for _ in range(3))
    q *= d ** -0.5
    bias = torch.randn((h, n, n), generator=gen) * 0.5
    mask = (torch.rand((nw, n, n), generator=gen) > 0.5).float() * -100.0 if nw else None
    if mask is not None:
        mask[:, ::5] = -100.0  # query rows masked at every key
    p = attention_fwd_plan(b, h, n, d, nw, sms=sms, resident=1)
    out, lse = _walk(q, k, v, bias, mask, p)
    ref = fused_window_attention_plain(q, k, v, bias, mask).double()
    assert (out - ref).abs().max().item() <= TOL_F32 * ref.abs().max().item()
    s = q.double() @ k.double().transpose(-1, -2) + bias.double()
    if mask is not None:
        s = (s.view(b // nw, nw, h, n, n) + mask.double()[None, :, None]).view(b, h, n, n)
    ref_lse = torch.logsumexp(s, -1)
    assert (lse - ref_lse).abs().max().item() <= 1e-5 * ref_lse.abs().max().item()
