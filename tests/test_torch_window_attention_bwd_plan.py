"""The window attention backward's plan (``attention_bwd_plan``), on the CPU.

``attention_bwd_plan`` makes on the host the plan that csrc/window_attention_bwd.cu makes on
the card: the route, the key tile and query rows of a block's step, the shared memory, the
runs of windows, the partials and the launches (tests/test_torch_cuda_kernels.py holds the
two equal on the card). Here it is held to what the kernel needs at every attention site of
the float32 SwinUNETR step (chip_smoke.py phase 9), the bench SwinUNETR's head-dim-8 sites
and the card tests' (D, N) grid: its shared memory fits a block, every (window, head, key)
belongs to one block's tile, each run walks its windows in the order of their mask rows, and
its partials match its launches. And a walk over its decomposition in float64, as the kernel
walks it (runs, key tiles, query chunks, the row splits of dK and dV, the key splits of dQ,
the dQ and dbias partials added in order), gives ``fused_window_attention_backward_plain``'s
result to 1e-10 of max|ref| (float64 sums in another order).
"""
import pytest
import torch

from chip_smoke import SWIN_ATTN_SITES
from monai_tpu_torch.ops.window_attention import _bwd_smem, attention_bwd_plan, fused_window_attention_backward_plain

BLOCK_SHARED, SM_SHARED = 232448, 233472  # an H100 block's most shared memory, an SM's
# the bench SwinUNETR (feature size 24) at its 6-window sliding-window batch, head dim 8
BENCH_ATTN_SITES = {(2058, 3, 343, 8, 343): 1, (2058, 3, 343, 8, None): 1, (384, 6, 343, 8, 64): 1,
                    (384, 6, 343, 8, None): 1, (48, 12, 343, 8, 8): 1, (48, 12, 343, 8, None): 1,
                    (6, 24, 216, 8, None): 2}
# the step's sites at head dim 8, as chip_smoke.py phase 9 also times them
STEP_D8_SITES = [(b, h, n, 8, nw) for (b, h, n, _, nw) in SWIN_ATTN_SITES]
# tests/test_torch_cuda_kernels.py: its grid of head dims and N (6 windows, 2 heads)
CARD_GRID = [(6, 2, n, d, nw) for d in (4, 12, 20, 32) for n in (27, 125, 512, 729) for nw in (None, 3)]
SITES = list(SWIN_ATTN_SITES) + list(BENCH_ATTN_SITES) + STEP_D8_SITES + CARD_GRID


def _cdiv(a, b):
    return -(-a // b)


def _blocks(p, b, h, n, nw):
    """(run, head, key tile, windows in walk order) of each main block."""
    per_row = b // (nw or 1)
    for split in range(p["splits"]):
        p0, p1 = split * p["windows_per_block"], min(b, (split + 1) * p["windows_per_block"])
        for hh in range(h):
            for kt in range(p["key_tiles"]):
                yield split, hh, kt, [pp // per_row + (nw or 1) * (pp % per_row) for pp in range(p0, p1)]


def test_the_step_has_its_sites():
    assert sum(SWIN_ATTN_SITES.values()) == 8 and sum(BENCH_ATTN_SITES.values()) == 8


@pytest.mark.parametrize("b,h,n,d,nw", SITES)
def test_plan_invariants(b, h, n, d, nw):
    p = attention_bwd_plan(b, h, n, d, nw or 0, torch.float32)
    assert p["route"] == "tf32x3" and p["cluster"] == 1 and p["threads"] == 256
    assert p["head_dim"] == (8 if d <= 8 else 16 if d <= 16 else 32)
    assert p["smem_bytes"] <= BLOCK_SHARED and p["blocks_per_sm"] * (p["smem_bytes"] + 1024) <= SM_SHARED
    # the widest key tile that fits; 2048 scores a step
    assert p["key_tile"] in (64, 32, 16) and p["key_tile"] * p["query_rows"] == 2048
    assert p["smem_bytes"] == _bwd_smem(n, p["key_tile"], p["head_dim"]) >= 8 * n * p["key_tile"]
    if p["key_tile"] < 64:
        assert _bwd_smem(n, 2 * p["key_tile"], p["head_dim"]) > BLOCK_SHARED
    assert p["key_tiles"] == _cdiv(n, p["key_tile"]) and p["chunks"] == _cdiv(n, p["query_rows"])
    # the runs cover every window once; partials and launches
    run, splits = p["windows_per_block"], p["splits"]
    assert (splits - 1) * run < b <= splits * run
    assert p["blocks"] == h * p["key_tiles"] * splits
    assert p["dq_partials"] == (p["key_tiles"] if p["key_tiles"] > 1 else 0)
    assert p["dbias_partials"] == (splits if splits > 1 else 0)
    assert p["launches"] == (3 if p["dq_partials"] or p["dbias_partials"] else 2)


@pytest.mark.parametrize("b,h,n,d,nw", list(SWIN_ATTN_SITES) + list(BENCH_ATTN_SITES))
def test_every_window_head_and_key_belongs_to_one_tile(b, h, n, d, nw):
    """Each (window, head, key) is in one block's tile, and each block walks its run's
    windows in the order of their mask rows (window w uses row w % nW)."""
    p = attention_bwd_plan(b, h, n, d, nw or 0, torch.float32)
    owned = torch.zeros((b, h, p["key_tiles"]), dtype=torch.int32)
    for _, hh, kt, windows in _blocks(p, b, h, n, nw):
        rows = [w % (nw or 1) for w in windows]
        assert rows == sorted(rows)
        owned[windows, hh, kt] += 1
    assert bool((owned == 1).all())
    # a key tile holds its keys; the last one the rest
    assert (p["key_tiles"] - 1) * p["key_tile"] < n <= p["key_tiles"] * p["key_tile"]


def test_the_step_sites_take_wide_key_tiles():
    """At N = 343 and 216, D <= 16: 64 keys a block and 32 query rows a step, one block an SM
    (the (343, 64) addend and dbias tiles take 176 KB); the runs fill the card's 132 SMs in
    whole waves or close to them."""
    for (b, h, n, d, nw) in list(SWIN_ATTN_SITES) + list(BENCH_ATTN_SITES):
        p = attention_bwd_plan(b, h, n, d, nw or 0, torch.float32)
        assert (p["key_tile"], p["query_rows"], p["blocks_per_sm"]) == (64, 32, 1)
    p = attention_bwd_plan(1372, 3, 343, 16, 343, torch.float32)
    assert (p["splits"], p["blocks"]) == (22, 396)  # 3 waves of 132 blocks, 63 windows each


@pytest.mark.parametrize("sms,resident", [(132, 1), (114, 2), (8, 1)])
def test_runs_take_the_fewest_waves(sms, resident):
    """The runs fill the card's blocks (SMs x resident) in the fewest waves times the windows
    of a run and one more, the fewest runs of those."""
    b, h, n, d, nw = 256, 6, 343, 16, 64
    p = attention_bwd_plan(b, h, n, d, nw, torch.float32, sms=sms, resident=resident)
    base, slots = h * p["key_tiles"], sms * resident

    def cost(s):
        return _cdiv(base * s, slots) * (_cdiv(b, s) + 1)

    assert p["blocks_per_sm"] == resident
    runs = [s for s in range(1, b + 1) if _cdiv(b, _cdiv(b, s)) == s]
    assert all(cost(p["splits"]) <= cost(s) for s in runs)
    assert all(cost(s) > cost(p["splits"]) for s in runs if s < p["splits"])


def test_refused_shapes():
    with pytest.raises(ValueError, match=r"\(2, 1, 27, 64\)"):
        attention_bwd_plan(2, 1, 27, 64, 0, torch.float32)
    with pytest.raises(ValueError, match=r"\(2, 1, 3000, 8\)"):
        attention_bwd_plan(2, 1, 3000, 8, 0, torch.float32)
    with pytest.raises(ValueError):
        attention_bwd_plan(6, 1, 27, 8, 4, torch.float32)  # 6 windows under 4 mask rows
    with pytest.raises(TypeError):
        attention_bwd_plan(2, 1, 27, 8, 0, torch.float64)


def _walk(q, k, v, bias, mask, out, dout, p):
    """dq, dk, dv and dbias as the kernel adds them up, in float64."""
    b, h, n, d = q.shape
    nw = 0 if mask is None else mask.shape[0]
    kt_keys, qt, dp = p["key_tile"], p["query_rows"], p["head_dim"]
    # the kernel's warps: dV and dK in 16 x 8 tiles, split over the step's rows where there
    # are fewer than 8 of them; dQ likewise, split over the tile's keys
    tb, tc = 2 * (kt_keys // 16) * (dp // 8), qt // 16 * (dp // 8)
    row_parts, key_parts = (1 if tb >= 8 else 8 // tb), (1 if tc >= 8 else 8 // tc)
    s_all = q @ k.transpose(-1, -2) + bias
    if mask is not None:
        s_all = (s_all.view(b // nw, nw, h, n, n) + mask[None, :, None]).view(b, h, n, n)
    lse = torch.logsumexp(s_all, -1)  # the forward's
    delta = (dout * out).sum(-1)
    dq_part = torch.zeros((p["key_tiles"], b, h, n, d), dtype=torch.float64)
    db_part = torch.zeros((p["splits"], h, n, n), dtype=torch.float64)
    dk, dv = torch.zeros_like(q), torch.zeros_like(q)
    for split, hh, kt, windows in _blocks(p, b, h, n, nw):
        j0, j1 = kt * kt_keys, min(n, (kt + 1) * kt_keys)
        for w in windows:
            add = bias[hh, :, j0:j1] + (0 if mask is None else mask[w % nw, :, j0:j1])
            kk, vv = k[w, hh, j0:j1], v[w, hh, j0:j1]
            acc_k = torch.zeros((row_parts, j1 - j0, d), dtype=torch.float64)
            acc_v = torch.zeros_like(acc_k)
            for c0 in range(0, n, qt):
                rows = slice(c0, min(n, c0 + qt))
                qq, gg = q[w, hh, rows], dout[w, hh, rows]
                pp = torch.exp(qq @ kk.T + add[rows] - lse[w, hh, rows, None])
                ds = pp * (gg @ vv.T - delta[w, hh, rows, None])
                db_part[split, hh, rows, j0:j1] += ds
                for x in range(row_parts):  # the row splits of dK and dV
                    sub = slice(x * qt // row_parts, (x + 1) * qt // row_parts)
                    acc_v[x] += pp[sub].T @ gg[sub]
                    acc_k[x] += ds[sub].T @ qq[sub]
                part = None
                for x in range(key_parts):  # the key splits of dQ, added in order
                    sub = slice(x * kt_keys // key_parts, (x + 1) * kt_keys // key_parts)
                    term = ds[:, sub] @ kk[sub]
                    part = term if part is None else part + term
                dq_part[kt, w, hh, rows] = part
            for x in range(row_parts):  # in order
                dk[w, hh, j0:j1] += acc_k[x]
                dv[w, hh, j0:j1] += acc_v[x]
    dq, dbias = dq_part[0].clone(), db_part[0].clone()
    for x in range(1, p["key_tiles"]):
        dq += dq_part[x]
    for x in range(1, p["splits"]):
        dbias += db_part[x]
    return dq, dk, dv, dbias


@pytest.mark.parametrize("b,h,n,d,nw,sms", [
    (12, 3, 27, 8, 4, 4),     # runs of 3 windows, one key tile, one chunk
    (12, 3, 27, 8, 0, 4),     # no mask
    (4, 2, 343, 16, 2, 132),  # a 7^3 window: 6 key tiles, 11 chunks
    (8, 2, 216, 16, 4, 4),    # runs over two mask rows, 4 key tiles of a 6^3 window
    (6, 1, 100, 32, 3, 2),    # head dim 32: no split of dQ's keys or of dK's rows
    (3, 1, 729, 8, 0, 1),     # N = 729: key tiles of 32, query chunks of 64
])
def test_walk_over_the_plan_gives_the_backward(b, h, n, d, nw, sms):
    gen = torch.Generator().manual_seed(b * 100 + n + d)
    q, k, v, dout = (torch.randn((b, h, n, d), generator=gen, dtype=torch.float64) for _ in range(4))
    q *= d ** -0.5
    bias = torch.randn((h, n, n), generator=gen, dtype=torch.float64) * 0.5
    mask = (torch.rand((nw, n, n), generator=gen) > 0.5).double() * -100.0 if nw else None
    s = q @ k.transpose(-1, -2) + bias
    if mask is not None:
        s = (s.view(b // nw, nw, h, n, n) + mask[None, :, None]).view(b, h, n, n)
    out = torch.softmax(s, -1) @ v
    p = attention_bwd_plan(b, h, n, d, nw, torch.float32, sms=sms, resident=1)
    got = _walk(q, k, v, bias, mask, out, dout, p)
    ref = fused_window_attention_backward_plain(q, k, v, bias, mask, out, dout)
    for a, r in zip(got, ref):
        assert r.dtype == torch.float64
        assert (a - r).abs().max().item() <= 1e-10 * r.abs().max().item()
