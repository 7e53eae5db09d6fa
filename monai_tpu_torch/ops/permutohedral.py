"""Exact permutohedral-lattice filtering (Adams, Baek and Davis 2010), counterpart of
monai_tpu/ops/permutohedral.py.

The same algorithm: elevate the sigma-scaled features onto the lattice's hyperplane,
find each point's enclosing simplex and barycentric weights, splat onto the simplex's
vertices, blur [1, 2, 1] along each of the d + 1 lattice directions, slice. The vertex
table is ``torch.unique(dim=0, return_inverse=True)`` over all N·(d+1) vertex keys: the
unique keys in lexicographic order and each key's segment id in one call. A blur
neighbour is found by a lexicographic binary search of that table, log2(M) steps; a
missing neighbour adds zero.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["permutohedral_filter"]


def _elevate(feat: torch.Tensor) -> torch.Tensor:
    """(N, d) sigma-scaled features onto the hyperplane H_d of R^{d+1}, with the published
    algorithm's variance-matching scale."""
    n, d = feat.shape
    inv_std = math.sqrt(2.0 / 3.0) * (d + 1)
    scale = torch.tensor([inv_std / math.sqrt((i + 1) * (i + 2)) for i in range(d)], dtype=torch.float32,
                         device=feat.device)
    cf = feat * scale
    suffix = torch.flip(torch.cumsum(torch.flip(cf, (1,)), dim=1), (1,))  # suffix[:, i] = sum_{j >= i} cf[j]
    tail = torch.cat([suffix[:, 1:], cf.new_zeros((n, 1))], dim=1)
    idx = torch.arange(1, d + 1, dtype=torch.float32, device=feat.device)
    return torch.cat([suffix[:, :1], tail - idx * cf], dim=1)


def _simplex(elevated: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The enclosing simplex: vertex keys (N, d+1 vertices, d+1) int64 and barycentric
    weights (N, d+1) float32, by the published rank and remainder construction."""
    n, dp1 = elevated.shape
    d = dp1 - 1
    rem0 = torch.round(elevated / (d + 1)) * (d + 1)  # the nearest 0-coloured lattice point
    rsum = rem0.sum(dim=1) / (d + 1)
    diff = elevated - rem0
    # rank[i] = #{j : diff[j] > diff[i] or (diff[j] == diff[i] and j < i)}
    gt = diff[:, :, None] < diff[:, None, :]
    eq = diff[:, :, None] == diff[:, None, :]
    jlt = torch.ones((dp1, dp1), dtype=torch.bool, device=elevated.device).tril(-1)[None]
    rank = (gt | (eq & jlt)).sum(dim=2) + rsum.to(torch.int32)[:, None]
    rem0 = torch.where(rank < 0, rem0 + dp1, rem0)
    rank = torch.where(rank < 0, rank + dp1, rank)
    rem0 = torch.where(rank > d, rem0 - dp1, rem0)
    rank = torch.where(rank > d, rank - dp1, rank)
    dscaled = (elevated - rem0) / dp1
    bary = torch.zeros((n, d + 2), dtype=torch.float32, device=elevated.device)
    bary.scatter_add_(1, d - rank, dscaled)
    bary.scatter_add_(1, d + 1 - rank, -dscaled)
    bary[:, 0] += 1.0 + bary[:, d + 1]
    k = torch.arange(dp1, device=elevated.device)[None, :, None]  # (1, vertex, 1)
    offs = torch.where(rank[:, None, :] <= d - k, k, k - dp1)  # (N, vertex, dim)
    return rem0.to(torch.int32).long()[:, None, :] + offs, bary[:, :dp1]


def _lex_less(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """rows (Q, K) lexicographically < q (Q, K), row by row."""
    neq = rows != q
    first = neq.to(torch.uint8).argmax(dim=1, keepdim=True)
    return neq.any(dim=1) & (rows.gather(1, first) < q.gather(1, first))[:, 0]


def _lex_find(table: torch.Tensor, queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary search of the lexicographically sorted rows of ``table`` (U, K) for each row
    of ``queries`` (Q, K): (index, found)."""
    u = table.shape[0]
    lo = torch.zeros(queries.shape[0], dtype=torch.long, device=table.device)
    hi = torch.full_like(lo, u)
    for _ in range(int(math.ceil(math.log2(max(u, 2)))) + 1):
        mid = (lo + hi) // 2
        less = _lex_less(table[mid.clamp(max=u - 1)], queries) & (lo < hi)
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less | (lo >= hi), hi, mid)
    idx = lo.clamp(max=u - 1)
    return idx, (table[idx] == queries).all(dim=1) & (lo < u)


def _filter_one(x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """x: (C, N) values, feat: (F, N) sigma-scaled features -> (C, N)."""
    c, n = x.shape
    dp1 = feat.shape[0] + 1
    keys, bary = _simplex(_elevate(feat.T))
    # a homogeneous channel: the lattice's constant gain cancels at the normalisation
    vals = torch.cat([x, x.new_ones((1, n))], dim=0)  # (C+1, N)
    w_flat = (vals.T[:, None, :] * bary[:, :, None]).reshape(n * dp1, c + 1)  # rows (point, vertex)
    table, seg = torch.unique(keys.reshape(n * dp1, dp1), dim=0, return_inverse=True)
    vertex_vals = x.new_zeros((table.shape[0], c + 1)).index_add_(0, seg, w_flat)
    for j in range(dp1):
        n1, n2 = table + 1, table - 1
        n1[:, j] -= dp1
        n2[:, j] += dp1
        i1, ok1 = _lex_find(table, n1)
        i2, ok2 = _lex_find(table, n2)
        v1 = torch.where(ok1[:, None], vertex_vals[i1], 0.0)
        v2 = torch.where(ok2[:, None], vertex_vals[i2], 0.0)
        vertex_vals = 0.5 * vertex_vals + 0.25 * (v1 + v2)
    out = (vertex_vals[seg.reshape(n, dp1)] * bary[:, :, None]).sum(dim=1)  # (N, C+1)
    return out[:, :c].T / out[:, c].clamp(min=1e-8)[None, :]


def permutohedral_filter(data: torch.Tensor, features: torch.Tensor, sigmas=None) -> torch.Tensor:
    """Gaussian filtering of ``data`` (B, C, *spatial) in the space of ``features``
    (B, F, *spatial), any F, feature i divided by ``sigmas[i]`` where given: the lattice
    approximates W_ij = exp(-|f_i - f_j|^2 / 2). float32 sums; returns data's type."""
    b, c = data.shape[:2]
    f = features.shape[1]
    n = int(np.prod(data.shape[2:]))
    x, feat = data.reshape(b, c, n).float(), features.reshape(b, f, n).float()
    if sigmas is not None:
        feat = feat / torch.as_tensor(sigmas, dtype=torch.float32, device=feat.device).reshape(1, f, 1)
    out = torch.stack([_filter_one(x[i], feat[i]) for i in range(b)])
    return out.reshape(data.shape).to(data.dtype)
