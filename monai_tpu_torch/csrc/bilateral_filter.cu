// Brute-force bilateral filter of float32 planes, 2-D and 3-D, forward:
//
//   out[v] = sum_o ws[o] * wc(o, v) * x[clamp(v + o)] / sum_o ws[o] * wc(o, v)
//   wc(o, v) = exp(-(x[clamp(v + o)] - x[v])^2 * 0.5 / color_sigma^2)
//
// for every voxel v of every (batch, channel) plane, o over the cube [-r, r]^sd. ws is the
// spatial weight exp(-|o|^2 * 0.5 / spatial_sigma^2), rounded to float32 on the host. The
// clamped index is the edge padding, so no padded copy is made and sizes <= r work. Sums
// are float32, in a fixed order, so two calls give the same bits.
//
// Replaces monai_tpu/ops/pallas_filtering.py::_run_2d (body _kernel_2d) and ::_run_3d (body
// _kernel_3d), which DMA'd an edge-padded slab into VMEM and unrolled every tap.
//
// What bounds it on the card: the special-function unit's exp, 16 a clock on each SM
// against 128 float32 operations. A tap's weight ws(o) wc(o, v) is symmetric in the pair
// (v, v + o) and the centre's is 1, so the function needs (T - 1) / 2 exps a voxel of
// T = (2r+1)^sd taps (62 for a 3-D r = 2 filter, 60 for a 2-D r = 5 one), and the 8 bytes
// a voxel moves are far below that. The pair kernels (one instance a radius, 2-D r = 1..8,
// 3-D r = 1..3) compute each pair's weight once and give it to both voxels:
//
// - Think of the edge-padded image P. For o in O+ (the offsets above 0 in the order
//   slowest axis first), w_o(q) = exp2(log2 ws(o) - (P'[q+o] - P'[q])^2) serves voxel q
//   (its tap +o) and voxel q + o (its tap -o). P' is P staged times sqrt(k), k = log2(e) *
//   0.5 / color_sigma^2, and log2 ws(o) comes from the kernel's parameters, so a weight is
//   a difference, one FFMA and one ex2.approx.ftz.f32.
// - A thread walks the slowest axis (z in 3-D, y in 2-D) over a segment, one slice (row)
//   a step. It owns KM rows x KX columns of the slice: KM = 8, KX = 1 in 3-D; KM = 1,
//   KX = 6 in 2-D. At step t it computes every pair whose q lies in slice t at its columns
//   and whose q or q + o is its own voxel. The forward weight goes into slice t's sums;
//   the backward one into slice t + a's (a = o's slowest component, 0..r), kept in
//   registers (r + 1 slices of sums), so slice t is complete after step t and is written.
//   Pairs along the walked axis are shared with no halo; pairs that cross the rows a thread
//   owns are computed by both threads (the halo rows); pairs that cross columns go to the
//   neighbouring lane by one warp shuffle of the partner's sums per partner column, after
//   all the rows of that offset group. So a warp's first and last h lanes (h = ceil(r/KX))
//   only feed their neighbours, and a segment starts with r halo steps that compute only
//   the pairs reaching into it. bilateral_plan (ops/bilateral.py) counts the exps a voxel
//   that a shape's geometry computes: 87.7 at stage A (3-D r = 2), 73.3 at stage B.
// - Values are staged in shared memory minus one value m of the block, slice by slice in a
//   ring of r + 2 slices (the next one loaded during a step), so the sums are of values near
//   0 and a constant image comes back exactly: out = m + (num + P'[v]) / (den + 1) / sqrt(k).
//   The division is __fdividef by den + 1, in [1, T]: IEEE division takes a slow path for a
//   numerator of exactly 0, which every voxel of a flat region (a CT's air) has.
//   Every thread reaches every barrier and shuffle; threads past the image compute on the
//   clamped values and do not store.
//
// Each weight then costs, besides the exp, 2 float32 instructions to make it and 4 to add
// it to the two voxels, plus a shared load or a shuffle for a few of them: close to the 8
// issue slots a warp's exp takes on its quarter of the special-function units, so the exp
// unit and the issue slots bound the pair kernels together.
//
// Any other radius runs the tap kernels: one exp a tap, from a tile and its halo of r
// staged in shared memory (up to 48 KB: 2-D r <= 45, 3-D r <= 5), else read from global
// memory (L2); the same exp2 form, with log2 ws from a table on the card. Sharing a pair's
// exp there takes a weight for every offset o in O+ over the tile and its halo of |o|,
// sum over O+ of (32 + |ox|)(8 + |oy|) exps for 256 voxels in 2-D (times (4 + |oz|) / 4
// in 3-D): 0.92 and 0.96 of one a tap at 2-D r = 9, 10, more from 2-D r = 11 and 3-D
// r = 4 on (ROADMAP.md B2 keeps it open, with larger tiles).
//
// Every instance has a checked build (kCount) that also adds up the exps its threads
// compute; ops/bilateral.py::bilateral_exps runs it, and the card holds the count to the
// plan's.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "runtime_error.cuh"

namespace {

// the run-time-radius (tap) kernels
constexpr int kTileX = 32;  // threads along the contiguous axis: one warp a row
constexpr int kTileY = 8;
constexpr int kTileZ = 4;   // 3-D: each thread computes kTileZ voxels along z
constexpr int kThreads = kTileX * kTileY;
constexpr int kSharedBudget = 48 * 1024;  // bytes: the default per block, no opt-in needed

// the pair kernels
constexpr int kKm3 = 8;        // 3-D: rows of a slice a thread owns (one column)
constexpr int kKx2 = 6;        // 2-D: columns of a row a thread owns
constexpr int kWarps3 = 4;     // 3-D: warps a block, warps_x * warps_y
constexpr int kMaxR3 = 3, kMaxR2 = 8;
constexpr int kTable = (kMaxR3 + 1) * (2 * kMaxR3 + 1) * (2 * kMaxR3 + 1);  // >= (kMaxR2 + 1) * (2 kMaxR2 + 1)

// log2 ws(o) for the offsets with a non-negative slowest component, passed by value so
// that it sits in the kernel's parameter (constant) bank: [a][b][c] in 3-D, [a][c] in 2-D.
struct PairTable {
  float v[kTable];
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int R>
__host__ __device__ constexpr int pair3_tile(int wx) {  // floats of one staged slice of a 3-D pair block
  return (wx * (32 - 2 * R) + 4 * R) * ((kWarps3 / wx) * kKm3 + 2 * R);
}

template <int R>
__host__ __device__ constexpr int pair3_prefetch() {  // staged floats a thread, at the widest of the block shapes
  constexpr int a = pair3_tile<R>(1), b = pair3_tile<R>(2), c = pair3_tile<R>(4);
  return cdiv(a > b ? (a > c ? a : c) : (b > c ? b : c), 32 * kWarps3);
}

template <int R>
constexpr size_t pair3_smem(int wx) {  // bytes: the ring of R + 2 staged slices
  return sizeof(float) * (R + 2) * pair3_tile<R>(wx);
}

__host__ __device__ constexpr int pair2_halo(int r) { return cdiv(r, kKx2); }
__host__ __device__ constexpr int pair2_cols(int r) { return (32 - 2 * pair2_halo(r)) * kKx2; }
__host__ __device__ constexpr int pair2_width(int r) { return pair2_cols(r) + 2 * (pair2_halo(r) * kKx2 + r); }
constexpr size_t pair2_smem(int r) { return sizeof(float) * (r + 2) * pair2_width(r); }  // the ring of r + 2 rows

// 3-D pair kernel. A block of 4 warps, warps_x along x times warps_y along y; a warp owns
// 8 rows x (32 - 2R) output columns of each slice (one column a lane, R halo lanes at each
// end) and walks the slices [t0, t1) of its segment. blockIdx.x enumerates (plane,
// segment, row tile, column tile), the column tile fastest.
// kCount: the checked build, which also adds the exps its threads compute to *exps.
template <int R, bool kCount>
__global__ void __launch_bounds__(32 * kWarps3)  // asking for 3 blocks an SM timed slower at r = 2
bilateral_3d_pair(const float* __restrict__ in, float* __restrict__ out, int d, int h, int w, float sc,
                  __grid_constant__ const PairTable tab, int wx, int seg, int tiles_x, int tiles_y, int tiles_s,
                  unsigned long long* __restrict__ exps) {
  constexpr int KM = kKm3, H = R, OX = 32 - 2 * H, NR = KM + 2 * R, RING = R + 2, W2 = 2 * R + 1;
  constexpr int PF = pair3_prefetch<R>(), NT = 32 * kWarps3;
  extern __shared__ float ring[];
  const int wy = kWarps3 / wx;
  int bid = blockIdx.x;
  const int bx = bid % tiles_x;
  bid /= tiles_x;
  const int by = bid % tiles_y;
  bid /= tiles_y;
  const int bs = bid % tiles_s;
  const long long hw = (long long)h * w, plane = (long long)(bid / tiles_s) * d * hw;
  const float* src = in + plane;
  float* dst = out + plane;
  const int lane = threadIdx.x & 31, wxi = (threadIdx.x >> 5) % wx, wyi = (threadIdx.x >> 5) / wx;
  const int x_b = bx * wx * OX, y_b = by * wy * KM, t0 = bs * seg, t1 = min(t0 + seg, d);
  const int tw = wx * OX + 4 * R, tsz = tw * (wy * KM + 2 * R);
  const float m = __ldg(src + (long long)t0 * hw + (long long)y_b * w + x_b);
  const float isc = 1.f / sc;

  // the staged tile: rows [y_b - R, y_b + wy KM + R), columns [x_b - H - R, x_b + wx OX + H + R),
  // clamped; each thread's elements at the same offsets in every slice
  int off[PF];
  float pf[PF];
#pragma unroll
  for (int k = 0; k < PF; ++k) {
    const int i = threadIdx.x + k * NT, r = i / tw;
    off[k] = i < tsz ? clampi(y_b - R + r, h - 1) * w + clampi(x_b - H - R + i - r * tw, w - 1) : -1;
  }
  auto fetch = [&](int s) {
    const float* sp = src + (long long)clampi(s, d - 1) * hw;
#pragma unroll
    for (int k = 0; k < PF; ++k) pf[k] = off[k] >= 0 ? (__ldg(sp + off[k]) - m) * sc : 0.f;
  };
  auto stash = [&](int s) {
    float* slot = ring + ((s - t0 + R) % RING) * tsz;
#pragma unroll
    for (int k = 0; k < PF; ++k)
      if (off[k] >= 0) slot[threadIdx.x + k * NT] = pf[k];
  };
  for (int s = t0 - R; s <= t0; ++s) {
    fetch(s);
    stash(s);
  }
  __syncthreads();

  const int tile_off = wyi * KM * tw + wxi * OX + lane + R;  // this lane's column, its rows from -R
  float an[R + 1][KM], ad[R + 1][KM];  // sums of slices t .. t + R
  unsigned n_exp = 0;
#pragma unroll
  for (int a = 0; a <= R; ++a)
#pragma unroll
    for (int i = 0; i < KM; ++i) an[a][i] = ad[a][i] = 0.f;

  for (int t = t0 - R; t < t1; ++t) {
    const bool more = t + 1 < t1;
    if (more) fetch(t + R + 1);
    const float* sq = ring + ((t - t0 + R) % RING) * tsz + tile_off;
    float q[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) q[i] = sq[i * tw];
#pragma unroll
    for (int a = 0; a <= R; ++a) {
      if (a < t0 - t) continue;  // a halo step: only the pairs that reach slice t0
      const float* sp = ring + ((t + a - t0 + R) % RING) * tsz + tile_off;
#pragma unroll 1
      for (int c = -R; c <= R; ++c) {
        float p[NR], bn[KM], bd[KM];
#pragma unroll
        for (int i = 0; i < NR; ++i) p[i] = sp[i * tw + c];
#pragma unroll
        for (int i = 0; i < KM; ++i) bn[i] = bd[i] = 0.f;
#pragma unroll
        for (int b = -R; b <= R; ++b) {
          if (a == 0 && (b < 0 || (b == 0 && c <= 0))) continue;  // o must lie above 0
          const float lw = tab.v[(a * W2 + b + R) * W2 + c + R];
#pragma unroll
          for (int iq = -R; iq < KM + R; ++iq) {
            const int ip = iq + b;
            const bool fwd = iq >= 0 && iq < KM, bwd = ip >= 0 && ip < KM;
            if (!fwd && !bwd) continue;
            const float vq = q[iq + R], vp = p[ip + R], df = vp - vq;
            const float wt = ex2(fmaf(-df, df, lw));
            if (kCount) ++n_exp;
            if (fwd) {
              an[0][iq] = fmaf(wt, vp, an[0][iq]);
              ad[0][iq] += wt;
            }
            if (bwd) {
              bn[ip] = fmaf(wt, vq, bn[ip]);
              bd[ip] += wt;
            }
          }
        }
        if (c != 0) {  // the partners are lane + c's voxels: take lane - c's sums for ours
          const int from = (lane - c) & 31;
#pragma unroll
          for (int i = 0; i < KM; ++i) {
            bn[i] = __shfl_sync(0xffffffffu, bn[i], from);
            bd[i] = __shfl_sync(0xffffffffu, bd[i], from);
          }
        }
#pragma unroll
        for (int i = 0; i < KM; ++i) {
          an[a][i] += bn[i];
          ad[a][i] += bd[i];
        }
      }
    }
    const int x = x_b + wxi * OX - H + lane;
    if (t >= t0 && lane >= H && lane < 32 - H && x < w) {
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        const int y = y_b + wyi * KM + i;
        if (y < h) dst[(long long)t * hw + (long long)y * w + x] = m + __fdividef(an[0][i] + q[i + R], ad[0][i] + 1.f) * isc;
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        an[a][i] = an[a + 1][i];
        ad[a][i] = ad[a + 1][i];
      }
#pragma unroll
    for (int i = 0; i < KM; ++i) an[R][i] = ad[R][i] = 0.f;
    if (more) stash(t + R + 1);
    __syncthreads();
  }
  if (kCount) atomicAdd(exps, (unsigned long long)n_exp);
}

// 2-D pair kernel. A block of one warp (one warp a block ran faster than three side by
// side at the filtering path's 512 x 512 slices); a lane owns 6 columns of a row, the warp
// (32 - 2h) * 6 output columns (h halo lanes at each end), and it walks the rows [t0, t1)
// of its segment. blockIdx.x enumerates (plane, segment, column tile).
template <int R, bool kCount>
__global__ void __launch_bounds__(32, R <= 5 && !kCount ? 16 : 1)  // r <= 5: <= 128 registers, 16 warps an SM
bilateral_2d_pair(const float* __restrict__ in, float* __restrict__ out, int h, int w, float sc,
                  __grid_constant__ const PairTable tab, int seg, int tiles_x, int tiles_s,
                  unsigned long long* __restrict__ exps) {
  constexpr int KX = kKx2, H = pair2_halo(R), OX = pair2_cols(R), NP = KX + 2 * R, RING = R + 2, W2 = 2 * R + 1;
  constexpr int TW = pair2_width(R), PF = cdiv(TW, 32);
  extern __shared__ float ring[];
  int bid = blockIdx.x;
  const int bx = bid % tiles_x;
  bid /= tiles_x;
  const int bs = bid % tiles_s;
  const long long plane = (long long)(bid / tiles_s) * h * w;
  const float* src = in + plane;
  float* dst = out + plane;
  const int lane = threadIdx.x;
  const int x_b = bx * OX, t0 = bs * seg, t1 = min(t0 + seg, h);
  const float m = __ldg(src + (long long)t0 * w + x_b);
  const float isc = 1.f / sc;

  int off[PF];  // the staged row: columns [x_b - H KX - R, x_b + OX + H KX + R), clamped
  float pf[PF];
#pragma unroll
  for (int k = 0; k < PF; ++k) {
    const int i = lane + k * 32;
    off[k] = i < TW ? clampi(x_b - H * KX - R + i, w - 1) : -1;
  }
  auto fetch = [&](int s) {
    const float* sp = src + (long long)clampi(s, h - 1) * w;
#pragma unroll
    for (int k = 0; k < PF; ++k) pf[k] = off[k] >= 0 ? (__ldg(sp + off[k]) - m) * sc : 0.f;
  };
  auto stash = [&](int s) {
    float* slot = ring + ((s - t0 + R) % RING) * TW;
#pragma unroll
    for (int k = 0; k < PF; ++k)
      if (off[k] >= 0) slot[lane + k * 32] = pf[k];
  };
  for (int s = t0 - R; s <= t0; ++s) {
    fetch(s);
    stash(s);
  }
  __syncthreads();

  const int col = lane * KX + R;  // this lane's first column in the staged row
  float an[R + 1][KX], ad[R + 1][KX];        // sums of rows t .. t + R
  unsigned n_exp = 0;
#pragma unroll
  for (int a = 0; a <= R; ++a)
#pragma unroll
    for (int j = 0; j < KX; ++j) an[a][j] = ad[a][j] = 0.f;

  for (int t = t0 - R; t < t1; ++t) {
    const bool more = t + 1 < t1;
    if (more) fetch(t + R + 1);
    const float* sq = ring + ((t - t0 + R) % RING) * TW + col;
    float q[KX];
#pragma unroll
    for (int j = 0; j < KX; ++j) q[j] = sq[j];
#pragma unroll
    for (int a = 0; a <= R; ++a) {
      if (a < t0 - t) continue;  // a halo step: only the pairs that reach row t0
      const float* sp = ring + ((t + a - t0 + R) % RING) * TW + col - R;
      float p[NP], on[2 * H + 1][KX], od[2 * H + 1][KX];  // the sums for lane + s's columns
#pragma unroll
      for (int i = 0; i < NP; ++i) p[i] = sp[i];
#pragma unroll
      for (int j = 0; j < KX; ++j)
#pragma unroll
        for (int s = 0; s <= 2 * H; ++s) on[s][j] = od[s][j] = 0.f;
#pragma unroll
      for (int j = 0; j < KX; ++j) {  // columns outer: timed faster at stage B than offsets outer
#pragma unroll
        for (int c = -R; c <= R; ++c) {
          if (a == 0 && c <= 0) continue;  // o must lie above 0
          const float lw = tab.v[a * W2 + c + R];
          const float vq = q[j], vp = p[j + c + R], df = vp - vq;
          const float wt = ex2(fmaf(-df, df, lw));
          if (kCount) ++n_exp;
          an[0][j] = fmaf(wt, vp, an[0][j]);
          ad[0][j] += wt;
          const int jj = j + c, s = jj >= 0 ? jj / KX : -((KX - 1 - jj) / KX), jp = jj - s * KX;
          if (s == 0) {  // a partner in this lane's own columns
            an[a][jp] = fmaf(wt, vq, an[a][jp]);
            ad[a][jp] += wt;
          } else {
            on[s + H][jp] = fmaf(wt, vq, on[s + H][jp]);
            od[s + H][jp] += wt;
          }
        }
      }
      // the sums for lane + s's columns: take lane - s's for ours
#pragma unroll
      for (int s = -H; s <= H; ++s) {
        if (s == 0) continue;
        const int from = (lane - s) & 31;
#pragma unroll
        for (int jp = 0; jp < KX; ++jp) {
          if (s * KX + jp < -R || s * KX + jp > KX - 1 + R || (a == 0 && s < 0)) continue;  // no pair reaches it
          an[a][jp] += __shfl_sync(0xffffffffu, on[s + H][jp], from);
          ad[a][jp] += __shfl_sync(0xffffffffu, od[s + H][jp], from);
        }
      }
    }
    if (t >= t0 && lane >= H && lane < 32 - H) {
#pragma unroll
      for (int j = 0; j < KX; ++j) {
        const int x = x_b + (lane - H) * KX + j;
        if (x < w) dst[(long long)t * w + x] = m + __fdividef(an[0][j] + q[j], ad[0][j] + 1.f) * isc;
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int j = 0; j < KX; ++j) {
        an[a][j] = an[a + 1][j];
        ad[a][j] = ad[a + 1][j];
      }
#pragma unroll
    for (int j = 0; j < KX; ++j) an[R][j] = ad[R][j] = 0.f;
    if (more) stash(t + R + 1);
    __syncthreads();
  }
  if (kCount) atomicAdd(exps, (unsigned long long)n_exp);
}

// The tap kernels: one voxel a thread (four along z in 3-D), one exp a tap but the centre's.
// lw: log2 ws(o) for every tap, row-major over the offsets. One block per (plane, 8-row,
// 32-column) tile; blockIdx.x enumerates them. kCount as in the pair kernels.
template <bool kShared, bool kCount>
__global__ void __launch_bounds__(kThreads)
bilateral_2d_tap(const float* __restrict__ in, float* __restrict__ out, const float* __restrict__ lw, int h, int w,
                 int r, float nk, int tiles_x, int tiles_y, unsigned long long* __restrict__ exps) {
  extern __shared__ float tile[];
  const int bx = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int by = rest % tiles_y;
  const long long plane = (long long)(rest / tiles_y) * h * w;
  const float* src = in + plane;
  const int x0 = bx * kTileX, y0 = by * kTileY;
  const int tw = kTileX + 2 * r, th = kTileY + 2 * r;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (kShared) {
    for (int i = ty * kTileX + tx; i < tw * th; i += kThreads) {
      const int ly = i / tw, lx = i - ly * tw;
      tile[i] = __ldg(src + (long long)clampi(y0 - r + ly, h - 1) * w + clampi(x0 - r + lx, w - 1));
    }
    __syncthreads();
  }
  const int x = min(x0 + tx, w - 1), y = min(y0 + ty, h - 1);  // past the edge: the edge's values, not stored
  const float c = kShared ? tile[(ty + r) * tw + tx + r] : __ldg(src + (long long)y * w + x);
  float num = 0.f, den = 1.f;  // the centre: weight 1, difference 0
  unsigned n_exp = 0;
  int t = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const float* row = kShared ? tile + (ty + r + dy) * tw + tx + r : src + (long long)clampi(y + dy, h - 1) * w;
    for (int dx = -r; dx <= r; ++dx, ++t) {
      if (dy == 0 && dx == 0) continue;
      const float df = (kShared ? row[dx] : __ldg(row + clampi(x + dx, w - 1))) - c;
      const float wt = ex2(fmaf(df * df, nk, __ldg(lw + t)));
      if (kCount) ++n_exp;
      num = fmaf(wt, df, num);
      den += wt;
    }
  }
  if (x0 + tx < w && y0 + ty < h) out[plane + (long long)y * w + x] = c + __fdividef(num, den);
  if (kCount) atomicAdd(exps, (unsigned long long)n_exp);
}

// One block per (plane, 4-slice, 8-row, 32-column) tile; each thread walks its 4 slices.
template <bool kShared, bool kCount>
__global__ void __launch_bounds__(kThreads)
bilateral_3d_tap(const float* __restrict__ in, float* __restrict__ out, const float* __restrict__ lw, int d, int h,
                 int w, int r, float nk, int tiles_x, int tiles_y, int tiles_z, unsigned long long* __restrict__ exps) {
  extern __shared__ float tile[];
  const int bx = blockIdx.x % tiles_x;
  int rest = blockIdx.x / tiles_x;
  const int by = rest % tiles_y;
  rest /= tiles_y;
  const int bz = rest % tiles_z;
  const long long plane = (long long)(rest / tiles_z) * d * h * w;
  const float* src = in + plane;
  const int x0 = bx * kTileX, y0 = by * kTileY, z0 = bz * kTileZ;
  const int tw = kTileX + 2 * r, th = kTileY + 2 * r, td = kTileZ + 2 * r;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (kShared) {
    for (int i = ty * kTileX + tx; i < tw * th * td; i += kThreads) {
      const int lz = i / (tw * th);
      const int j = i - lz * tw * th;
      const int ly = j / tw, lx = j - ly * tw;
      tile[i] = __ldg(src + ((long long)clampi(z0 - r + lz, d - 1) * h + clampi(y0 - r + ly, h - 1)) * w +
                      clampi(x0 - r + lx, w - 1));
    }
    __syncthreads();
  }
  const int x = min(x0 + tx, w - 1), y = min(y0 + ty, h - 1);  // past the edge: the edge's values, not stored
  const bool store = x0 + tx < w && y0 + ty < h;
  for (int lz = 0; lz < kTileZ; ++lz) {
    const int z = z0 + lz;
    if (z >= d) break;  // the same for the whole block, after its only barrier
    const float c = kShared ? tile[((lz + r) * th + ty + r) * tw + tx + r]
                            : __ldg(src + ((long long)z * h + y) * w + x);
    float num = 0.f, den = 1.f;
    unsigned n_exp = 0;  // added up a voxel: a count kept over the slices spilled
    int t = 0;
    for (int dz = -r; dz <= r; ++dz) {
      for (int dy = -r; dy <= r; ++dy) {
        const float* row = kShared ? tile + ((lz + r + dz) * th + ty + r + dy) * tw + tx + r
                                   : src + ((long long)clampi(z + dz, d - 1) * h + clampi(y + dy, h - 1)) * w;
        for (int dx = -r; dx <= r; ++dx, ++t) {
          if (dz == 0 && dy == 0 && dx == 0) continue;
          const float df = (kShared ? row[dx] : __ldg(row + clampi(x + dx, w - 1))) - c;
          const float wt = ex2(fmaf(df * df, nk, __ldg(lw + t)));
          if (kCount) ++n_exp;
          num = fmaf(wt, df, num);
          den += wt;
        }
      }
    }
    if (store) out[plane + ((long long)z * h + y) * w + x] = c + __fdividef(num, den);
    if (kCount) atomicAdd(exps, (unsigned long long)n_exp);
  }
}

// The pair kernels stage values times sqrt(-nk), so that a weight's exponent is
// -(df * df) + log2 ws, one FFMA; below 1e-18 (color_sigma past ~1e18) the scale stays at
// 1e-18, where exp2(-(df * 1e-18)^2) is 1 in float32 for any |df| < 1e9.
float range_scale(float nk) { return nk > -1e-36f ? 1e-18f : sqrtf(-nk); }

template <int R>
int launch_pair3(const float* in, float* out, const float* lw_host, long long planes, int d, int h, int w, float nk,
                 int wx, int wy, int seg, int tiles_x, int tiles_y, int tiles_s, unsigned long long* exps,
                 cudaStream_t s) {
  constexpr int OX = 32 - 2 * R, W2 = 2 * R + 1;
  if ((wx != 1 && wx != 2 && wx != 4) || wy != kWarps3 / wx || seg <= 0 || tiles_x != cdiv(w, wx * OX) ||
      tiles_y != cdiv(h, wy * kKm3) || tiles_s != cdiv(d, seg))
    return (int)cudaErrorInvalidValue;
  const long long blocks = planes * tiles_x * tiles_y * tiles_s;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  PairTable tab{};
  for (int a = 0; a <= R; ++a)  // the taps are row-major over offsets from -R: a = dz, b = dy, c = dx
    for (int b = -R; b <= R; ++b)
      for (int c = -R; c <= R; ++c) tab.v[(a * W2 + b + R) * W2 + c + R] = lw_host[((a + R) * W2 + b + R) * W2 + c + R];
  const size_t smem = pair3_smem<R>(wx);
  auto* kernel = exps != nullptr ? &bilateral_3d_pair<R, true> : &bilateral_3d_pair<R, false>;
  kernel<<<(unsigned)blocks, 32 * kWarps3, smem, s>>>(in, out, d, h, w, range_scale(nk), tab, wx, seg, tiles_x, tiles_y,
                                                      tiles_s, exps);
  return (int)cudaGetLastError();
}

template <int R>
int launch_pair2(const float* in, float* out, const float* lw_host, long long planes, int h, int w, float nk,
                 int wx, int wy, int seg, int tiles_x, int tiles_y, int tiles_s, unsigned long long* exps,
                 cudaStream_t s) {
  constexpr int W2 = 2 * R + 1;
  if (wx != 1 || wy != 1 || seg <= 0 || tiles_x != cdiv(w, pair2_cols(R)) || tiles_y != 1 || tiles_s != cdiv(h, seg))
    return (int)cudaErrorInvalidValue;
  const long long blocks = planes * tiles_x * tiles_s;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  PairTable tab{};
  for (int a = 0; a <= R; ++a)  // the taps are row-major over offsets from -R: a = dy, c = dx
    for (int c = -R; c <= R; ++c) tab.v[a * W2 + c + R] = lw_host[(a + R) * W2 + c + R];
  const size_t smem = pair2_smem(R);
  auto* kernel = exps != nullptr ? &bilateral_2d_pair<R, true> : &bilateral_2d_pair<R, false>;
  kernel<<<(unsigned)blocks, 32, smem, s>>>(in, out, h, w, range_scale(nk), tab, seg, tiles_x, tiles_s, exps);
  return (int)cudaGetLastError();
}

// Blocks of a pair instance that an SM holds at once, as the CUDA runtime works it out
// from the instance's registers and shared memory; a negative cudaError_t on failure.
template <int R>
int resident3(int wx) {
  int n = 0;
  auto* kernel = &bilateral_3d_pair<R, false>;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * kWarps3, pair3_smem<R>(wx));
  return e == cudaSuccess ? n : -(int)cleared(e);
}

template <int R>
int resident2() {
  int n = 0;
  auto* kernel = &bilateral_2d_pair<R, false>;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32, pair2_smem(R));
  return e == cudaSuccess ? n : -(int)cleared(e);
}

}  // namespace

// The blocks of the pair instance for (sd, radius) with warps_x warps side by side (3-D;
// 1 in 2-D) that an SM of the current device holds at once: what bilateral_plan
// (ops/bilateral.py) sizes the segments with, read from the card to check it. A negative
// cudaError_t on failure.
extern "C" int monai_bilateral_resident(int sd, int radius, int warps_x) {
  if (sd == 3 && (warps_x == 1 || warps_x == 2 || warps_x == 4)) {
    switch (radius) {
      case 1: return resident3<1>(warps_x);
      case 2: return resident3<2>(warps_x);
      case 3: return resident3<3>(warps_x);
      default: break;
    }
  }
  if (sd == 2 && warps_x == 1) {
    switch (radius) {
      case 1: return resident2<1>();
      case 2: return resident2<2>();
      case 3: return resident2<3>();
      case 4: return resident2<4>();
      case 5: return resident2<5>();
      case 6: return resident2<6>();
      case 7: return resident2<7>();
      case 8: return resident2<8>();
      default: break;
    }
  }
  return -(int)cudaErrorInvalidValue;
}

// in and out: (planes, [d,] h, w) contiguous float32, sd = 2 (d ignored) or 3. nk =
// -log2(e) * 0.5 / color_sigma^2. lw_host: log2 ws(o), (2r+1)^sd float32 on the host,
// row-major over the offsets from -r (the pair kernels take their half into their
// parameters); lw_dev: the same on the card (the tap kernels). instance: 0 the pair kernel
// of this radius, 1 the tap kernel with shared memory, 2 the tap kernel reading global
// memory; warps_x, warps_y, seg and the tiles as bilateral_plan (ops/bilateral.py) makes
// them, checked here. exps: null, or one unsigned 64-bit integer on the card to which the
// checked build of the same instance adds the exps its threads compute. Returns a
// cudaError_t (0 on success); launches on `stream` and does not synchronise.
extern "C" int monai_bilateral_filter(const void* in, void* out, const void* lw_dev, const void* lw_host,
                                      long long planes, int sd, int d, int h, int w, int radius, float nk, int instance,
                                      int warps_x, int warps_y, int seg, int tiles_x, int tiles_y, int tiles_s,
                                      void* exps, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || radius < 0 || (sd != 2 && sd != 3) || (sd == 3 && d <= 0) ||
      (long long)h * w > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(in);
  auto* dst = static_cast<float*>(out);
  auto* cnt = static_cast<unsigned long long*>(exps);
  if (instance == 0) {
    const auto* lw = static_cast<const float*>(lw_host);
    if (lw == nullptr) return (int)cudaErrorInvalidValue;
    if (sd == 3) {
      switch (radius) {
        case 1: return launch_pair3<1>(src, dst, lw, planes, d, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
        case 2: return launch_pair3<2>(src, dst, lw, planes, d, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
        case 3: return launch_pair3<3>(src, dst, lw, planes, d, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    switch (radius) {
      case 1: return launch_pair2<1>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      case 2: return launch_pair2<2>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      case 3: return launch_pair2<3>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      case 4: return launch_pair2<4>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      case 5: return launch_pair2<5>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      case 6: return launch_pair2<6>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      case 7: return launch_pair2<7>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      case 8: return launch_pair2<8>(src, dst, lw, planes, h, w, nk, warps_x, warps_y, seg, tiles_x, tiles_y, tiles_s, cnt, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const auto* lw = static_cast<const float*>(lw_dev);
  const int tx = cdiv(w, kTileX), ty = cdiv(h, kTileY), tz = sd == 3 ? cdiv(d, kTileZ) : 1;
  if ((instance != 1 && instance != 2) || lw == nullptr || tiles_x != tx || tiles_y != ty || tiles_s != tz)
    return (int)cudaErrorInvalidValue;
  const long long blocks = planes * tx * ty * tz;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kTileX, kTileY);
  const long long halo_w = kTileX + 2LL * radius, halo_h = kTileY + 2LL * radius;
  const long long shared = (sd == 3 ? kTileZ + 2LL * radius : 1LL) * halo_h * halo_w * (long long)sizeof(float);
  const bool staged = instance == 1;
  if (staged && shared > kSharedBudget) return (int)cudaErrorInvalidValue;
  const size_t bytes = staged ? (size_t)shared : 0;
  const bool counted = cnt != nullptr;
  if (sd == 2) {
    auto* kernel = staged ? (counted ? &bilateral_2d_tap<true, true> : &bilateral_2d_tap<true, false>)
                          : (counted ? &bilateral_2d_tap<false, true> : &bilateral_2d_tap<false, false>);
    kernel<<<(unsigned)blocks, block, bytes, s>>>(src, dst, lw, h, w, radius, nk, tx, ty, cnt);
  } else {
    auto* kernel = staged ? (counted ? &bilateral_3d_tap<true, true> : &bilateral_3d_tap<true, false>)
                          : (counted ? &bilateral_3d_tap<false, true> : &bilateral_3d_tap<false, false>);
    kernel<<<(unsigned)blocks, block, bytes, s>>>(src, dst, lw, d, h, w, radius, nk, tx, ty, tz, cnt);
  }
  return (int)cudaGetLastError();
}
