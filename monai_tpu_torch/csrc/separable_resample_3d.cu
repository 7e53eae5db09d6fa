// Separable (diagonal-affine) resample of a channel-first float32 volume, forward:
//
//   out[c, i, j, k] = sum_a Wz[i, a] * sum_b Wy[j, b] * sum_e Wx[k, e] * in[c, a, b, e]
//
// Each W is the host-built 1-D interpolation matrix of one axis (orders 0, 1 and 3; bounds
// zeros, border and reflection), handed to the kernel as a tap table: for output row i,
// TAPS input indices and float32 weights (a row's nonzeros in ascending index order,
// padded with weight 0 to 1, 2 or 4 taps for orders 0, 1 and 3). A null table marks an
// axis whose matrix is the identity: no kernel contracts it. The host's plan
// (monai_tpu_torch/ops/separable_resample.py::resample_plan) says how a shape runs.
//
// Replaces monai_tpu/ops/pallas_resample.py::_build_call (body _make_kernel). That kernel
// DMA'd an input z-slab into VMEM and contracted all three axes there with dense weight
// matrices on the MXU, where a dense product is cheap. Here a dense (n_out, n_in) product
// would do 128-512 times the needed work (rows of up to 512 inputs against 1, 2 or 4
// taps), so each output sums its taps only, in float32 (fma in ascending index order).
//
// What bounds it on the card: memory. Orders 0 and 1 do 1-2 FMAs per element and pass,
// order 3 does 4; the least the card can do is read the input once and write the output
// once. Three passes through device memory, one an axis, move 2-5.5 times that at the
// spleen path's sites (float32 intermediates of up to 235 MB between them). So:
//
// - The fused route (one launch): a block owns an output tile of one channel, a few rows
//   on axes 1 and 2 and a run of 32-256 on the contiguous axis 3 (the whole axis where it
//   is no longer). It copies the input brick that tile needs (the band of each axis:
//   every nonzero tap of the tile's rows, rows with none left out) into shared memory by
//   cp.async, 16 bytes a copy where the x extent and the band start allow it (8 at the
//   spleen path's 90-wide Spacing input), a whole z-plane as one run where the band spans
//   whole x rows; and its rows of the three tap tables beside it, as (index, weight) pairs.
//   It contracts the brick axis by axis in shared memory, first the axes that shrink the
//   data (the plan's order: fewest elements written), and the last contraction writes the
//   tile to device memory once. No intermediate leaves the SM. Each contraction takes a
//   row a warp, its lanes on neighbouring x, and works out the row's addresses (and on
//   axes 1 and 2 its taps) once; no integer division runs per element or row.
//   Neighbouring bricks overlap by a few rows, which L2 mostly serves. The plan takes the
//   longest x run that fits 48 KB of shared memory a block (four blocks an SM, as many as
//   64 registers a thread allow), then the tile whose bricks move the fewest bytes.
//   Measured on the spleen path's sites, the copies, the contractions and the stores each
//   take a third of the time, and overlap only across the SM's blocks: a second brick
//   buffer, to copy the next tile while contracting this one, ran slower (fewer blocks an
//   SM), so a block takes one tile.
// - The axes route, for shapes whose brick does not fit 48 KB at any tile (strong
//   down-sampling: a run of 32 along x at 800x needs 20,000 input columns): one
//   grid-stride pass an axis, in the order that moves the fewest bytes through the float32
//   intermediates, each thread's (outer, row, inner) position advanced by the grid
//   stride's own decomposition (no division per element).
//
// Order 0 stays bit-identical to the dense product in any contraction order: one tap of
// weight 1.0 per row (fma(1, v, 0) = v) or a row of weight 0.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"
#include "runtime_error.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 64;

template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES));
  }
}

struct Fused {
  const float* in;
  float* out;
  int C, total;  // channels; tiles over all channels
  int nin[3], nout[3], tile[3], band[3], ntiles[3];
  const int* start[3];  // band start per tile; null for an identity axis
  const int* idx[3];    // (nout, TAPS), counted from the band start of the row's tile
  const float* w[3];
  int order[3];
  int nstages, vec;
  // shared memory, in floats: the first and second contraction's outputs (off2 < 0: over
  // the brick, which sits at 0) and the tap rows
  int off1, off2, off_taps;
};

// One tile of the output: its channel, and per axis its origin, rows, band start and
// the brick's extent (the band, or the tile's rows on an identity axis).
struct Tile {
  int c, org[3], len[3], st[3], dims[3];
};

__device__ __forceinline__ Tile tile_at(const Fused& a, int id) {
  Tile t;
  int ix[3];
  ix[2] = id % a.ntiles[2];
  id /= a.ntiles[2];
  ix[1] = id % a.ntiles[1];
  id /= a.ntiles[1];
  ix[0] = id % a.ntiles[0];
  t.c = id / a.ntiles[0];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    t.org[d] = ix[d] * a.tile[d];
    t.len[d] = min(a.tile[d], a.nout[d] - t.org[d]);
    t.st[d] = a.idx[d] ? a.start[d][ix[d]] : t.org[d];
    t.dims[d] = a.idx[d] ? a.band[d] : t.len[d];
  }
  return t;
}

// The boxes in shared memory are walked a row at a time: a warp takes rows warp,
// warp + kWarps, ... of the (d0, d1) rows, its lanes the row's x. A row's base addresses
// and, in the z and y contractions, its taps are worked out once a row; no integer
// division runs per element or row.
template <typename F>
__device__ __forceinline__ void for_rows(int d0, int d1, F&& f) {
  const int warp = threadIdx.x >> 5;
  int z = warp / d1, y = warp - z * d1;
  for (int row = warp; row < d0 * d1; row += kWarps) {
    f(row, z, y);
    for (y += kWarps; y >= d1; y -= d1) ++z;
  }
}

// the brick, (b0, b1, b2) floats, VEC a copy: a row at a time, or where the band spans
// whole x rows (b2 == xin) a z-plane at a time, its rows contiguous in both memories
template <int VEC, typename I>
__device__ __forceinline__ void load_brick(float* brick, const float* __restrict__ in, I row0, int yin, int xin,
                                           int s1, int s2, int b0, int b1, int b2) {
  if (b2 == xin) {
    const int nv = b1 * b2 / VEC;
    for (int z = 0; z < b0; ++z) {
      const float* src = in + ((row0 + z) * (I)yin + s1) * xin + s2;
      float* dst = brick + z * b1 * b2;
      for (int v = threadIdx.x; v < nv; v += kThreads) cp_async_bytes<4 * VEC>(dst + v * VEC, src + v * VEC);
    }
    return;
  }
  const int lane = threadIdx.x & 31, nv = b2 / VEC;
  for_rows(b0, b1, [&](int row, int z, int y) {
    const float* src = in + ((row0 + z) * (I)yin + s1 + y) * xin + s2;
    float* dst = brick + row * b2;
    for (int v = lane; v < nv; v += 32) cp_async_bytes<4 * VEC>(dst + v * VEC, src + v * VEC);
  });
}

template <typename I>
__device__ __forceinline__ void issue_brick(const Fused& a, const Tile& t, float* brick) {
  const I row0 = (I)t.c * a.nin[0] + t.st[0];
  if (a.vec == 4) {
    load_brick<4, I>(brick, a.in, row0, a.nin[1], a.nin[2], t.st[1], t.st[2], t.dims[0], t.dims[1], t.dims[2]);
  } else if (a.vec == 2) {
    load_brick<2, I>(brick, a.in, row0, a.nin[1], a.nin[2], t.st[1], t.st[2], t.dims[0], t.dims[1], t.dims[2]);
  } else {
    load_brick<1, I>(brick, a.in, row0, a.nin[1], a.nin[2], t.st[1], t.st[2], t.dims[0], t.dims[1], t.dims[2]);
  }
  cp_async_commit();
}

// One contraction along AXIS: dst (d0, d1, d2) from src, whose extent along AXIS is n;
// the tap rows are [TAPS][stride] pairs (input index, weight's bits), one 8-byte load a
// tap. LAST writes to device memory at g (the tile's origin; strides gz, gy) instead of
// dst.
template <int AXIS, int TAPS, bool LAST, typename I>
__device__ __forceinline__ void contract(const float* src, float* dst, int d0, int d1, int d2, int n,
                                         const int2* taps, int stride, float* __restrict__ g, I gz, I gy) {
  const int lane = threadIdx.x & 31;
  for_rows(d0, d1, [&](int row, int z, int y) {
    float* out = LAST ? g + (z * gz + y * gy) : dst + row * d2;
    if constexpr (AXIS == 2) {
      const float* in = src + row * n;
      for (int x = lane; x < d2; x += 32) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          const int2 q = taps[t * stride + x];
          acc = fmaf(__int_as_float(q.y), in[q.x], acc);
        }
        out[x] = acc;
      }
    } else {
      const int r = AXIS == 0 ? z : y;
      const float* in[TAPS];
      float wt[TAPS];
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const int2 q = taps[t * stride + r];
        in[t] = src + (AXIS == 0 ? q.x * d1 + y : z * n + q.x) * d2;
        wt[t] = __int_as_float(q.y);
      }
      for (int x = lane; x < d2; x += 32) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) acc = fmaf(wt[t], in[t][x], acc);
        out[x] = acc;
      }
    }
  });
}

template <int TAPS, bool LAST, typename I>
__device__ __forceinline__ void contract_axis(int axis, const float* src, float* dst, int d0, int d1, int d2, int n,
                                              const int2* taps, int stride, float* g, I gz, I gy) {
  if (axis == 0) contract<0, TAPS, LAST>(src, dst, d0, d1, d2, n, taps, stride, g, gz, gy);
  else if (axis == 1) contract<1, TAPS, LAST>(src, dst, d0, d1, d2, n, taps, stride, g, gz, gy);
  else contract<2, TAPS, LAST>(src, dst, d0, d1, d2, n, taps, stride, g, gz, gy);
}

// Axes are picked by value (a ? b : c), never by a run-time index into an array, so that
// nothing of a block's state goes to local memory.
__device__ __forceinline__ int pick(int axis, int v0, int v1, int v2) { return axis == 0 ? v0 : axis == 1 ? v1 : v2; }

// A block a tile.
template <int TAPS, typename I>
__global__ void __launch_bounds__(kThreads, 4) resample_fused_kernel(const Fused a) {
  extern __shared__ __align__(16) float sm[];
  const Tile cur = tile_at(a, blockIdx.x);
  issue_brick<I>(a, cur, sm);
  // the tile's tap rows, [TAPS][tile] (index, weight) pairs an axis, while the brick is in flight
  int2* taps[3] = {nullptr, nullptr, nullptr};
  int2* p = reinterpret_cast<int2*>(sm + a.off_taps);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (!a.idx[d]) continue;
    taps[d] = p;
    p += TAPS * a.tile[d];
    for (int r = threadIdx.x; r < cur.len[d]; r += kThreads) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const int k = (cur.org[d] + r) * TAPS + t;
        taps[d][t * a.tile[d] + r] = make_int2(__ldg(a.idx[d] + k), __float_as_int(__ldg(a.w[d] + k)));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const I gz = (I)a.nout[1] * a.nout[2], gy = a.nout[2];
  float* g = a.out + ((I)cur.c * a.nout[0] + cur.org[0]) * gz + (I)cur.org[1] * gy + cur.org[2];
  int dims[3] = {cur.dims[0], cur.dims[1], cur.dims[2]};
  const float* src = sm;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s >= a.nstages) break;
    const int ax = a.order[s];
    const int n = pick(ax, dims[0], dims[1], dims[2]);
    dims[0] = ax == 0 ? cur.len[0] : dims[0];
    dims[1] = ax == 1 ? cur.len[1] : dims[1];
    dims[2] = ax == 2 ? cur.len[2] : dims[2];
    const int2* tap = ax == 0 ? taps[0] : ax == 1 ? taps[1] : taps[2];
    const int stride = pick(ax, a.tile[0], a.tile[1], a.tile[2]);
    float* dst = s == 0 ? sm + a.off1 : a.off2 < 0 ? sm : sm + a.off2;
    if (s == a.nstages - 1) {
      contract_axis<TAPS, true>(ax, src, dst, dims[0], dims[1], dims[2], n, tap, stride, g, gz, gy);
    } else {
      contract_axis<TAPS, false>(ax, src, dst, dims[0], dims[1], dims[2], n, tap, stride, g, gz, gy);
      __syncthreads();
    }
    src = dst;
  }
  if (a.nstages == 0) {  // every axis the identity: the brick is the tile
    for_rows(dims[0], dims[1], [&](int row, int z, int y) {
      for (int x = threadIdx.x & 31; x < dims[2]; x += 32) g[z * gz + y * gy + x] = sm[row * dims[2] + x];
    });
  }
}

template <int TAPS, typename I>
cudaError_t launch_fused(const Fused& a, int smem, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(resample_fused_kernel<TAPS, I>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  resample_fused_kernel<TAPS, I><<<(unsigned)a.total, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One axis: in viewed as (outer, n_in, inner), out as (outer, n_out, inner). Element
// e = (o * n_out + i) * inner + n; a thread's e and the grid stride are decomposed once.
template <int TAPS, typename I>
__global__ void __launch_bounds__(kThreads)
resample_axis_kernel(const float* __restrict__ in, float* __restrict__ out, I outer, int n_out, I inner, int n_in,
                     const int* __restrict__ idx, const float* __restrict__ w) {
  const I e = (I)blockIdx.x * kThreads + threadIdx.x;
  const I stride = (I)gridDim.x * kThreads;
  I n = e % inner, o = e / inner;
  int i = (int)(o % n_out);
  o /= n_out;
  const I sn = stride % inner, sr = stride / inner;
  const int si = (int)(sr % n_out);
  const I so = sr / n_out;
  for (; o < outer;) {
    const float* src = in + o * n_in * inner + n;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
      acc = fmaf(__ldg(w + i * TAPS + t), __ldg(src + (I)__ldg(idx + i * TAPS + t) * inner), acc);
    out[(o * n_out + i) * inner + n] = acc;
    n += sn;
    if (n >= inner) { n -= inner; ++i; }
    i += si;
    if (i >= n_out) { i -= n_out; ++o; }
    o += so;
  }
}

template <int TAPS>
cudaError_t resample_axis(const float* in, float* out, long long outer, int n_in, int n_out, long long inner,
                          const int* idx, const float* w, cudaStream_t stream) {
  const long long total = outer * n_out * inner;
  const long long largest = total > outer * n_in * inner ? total : outer * n_in * inner;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (largest < (1LL << 30)) {  // 32-bit index math, with room for the grid stride
    resample_axis_kernel<TAPS, int32_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, (int32_t)outer, n_out, (int32_t)inner, n_in, idx, w);
  } else {
    resample_axis_kernel<TAPS, int64_t><<<(unsigned)blocks, kThreads, 0, stream>>>(in, out, outer, n_out, inner,
                                                                                  n_in, idx, w);
  }
  return cudaGetLastError();
}

template <int TAPS>
cudaError_t run(const void* in, void* out, void* tmp1, void* tmp2, const long long* p, cudaStream_t s,
                int* launched) {
  const int C = (int)p[1], nstages = (int)p[9];
  int nin[3], nout[3];
  for (int d = 0; d < 3; ++d) nin[d] = (int)p[2 + d], nout[d] = (int)p[5 + d];
  const int* idx[3];
  const float* w[3];
  for (int d = 0; d < 3; ++d) {
    idx[d] = reinterpret_cast<const int*>(p[30 + d]);
    w[d] = reinterpret_cast<const float*>(p[33 + d]);
    if (!idx[d] && nin[d] != nout[d]) return cudaErrorInvalidValue;
  }
  if (p[0] == 0) {  // fused
    Fused a;
    a.in = static_cast<const float*>(in);
    a.out = static_cast<float*>(out);
    a.C = C;
    for (int d = 0; d < 3; ++d) {
      a.nin[d] = nin[d], a.nout[d] = nout[d], a.tile[d] = (int)p[13 + d], a.ntiles[d] = (int)p[16 + d];
      a.band[d] = (int)p[19 + d], a.start[d] = reinterpret_cast<const int*>(p[27 + d]);
      a.idx[d] = idx[d], a.w[d] = w[d], a.order[d] = (int)p[10 + d];
      if (a.tile[d] <= 0 || a.band[d] < 0 || (idx[d] && !a.start[d])) return cudaErrorInvalidValue;
    }
    a.nstages = nstages, a.vec = (int)p[22], a.off1 = (int)p[23], a.off2 = (int)p[24], a.off_taps = (int)p[25];
    const long long total = (long long)C * a.ntiles[0] * a.ntiles[1] * a.ntiles[2];
    const int smem = (int)p[26];
    if (total >= (1LL << 31)) return cudaErrorInvalidValue;
    a.total = (int)total;
    const long long in_n = (long long)C * nin[0] * nin[1] * nin[2], out_n = (long long)C * nout[0] * nout[1] * nout[2];
    const cudaError_t err = (in_n < (1LL << 31) && out_n < (1LL << 31))
                                ? launch_fused<TAPS, int32_t>(a, smem, s)
                                : launch_fused<TAPS, int64_t>(a, smem, s);
    if (err == cudaSuccess) *launched = 1;
    return err;
  }
  // axes: one pass an axis in the plan's order, through tmp1 and tmp2
  if (nstages <= 0) return cudaErrorInvalidValue;
  long long dims[3] = {nin[0], nin[1], nin[2]};
  const float* src = static_cast<const float*>(in);
  for (int k = 0; k < nstages; ++k) {
    const int ax = (int)p[10 + k];
    if (ax < 0 || ax > 2 || !idx[ax]) return cudaErrorInvalidValue;
    float* dst = k == nstages - 1 ? static_cast<float*>(out) : static_cast<float*>(k == 0 ? tmp1 : tmp2);
    if (!dst) return cudaErrorInvalidValue;
    long long outer = C, inner = 1;
    for (int d = 0; d < ax; ++d) outer *= dims[d];
    for (int d = ax + 1; d < 3; ++d) inner *= dims[d];
    const cudaError_t err = resample_axis<TAPS>(src, dst, outer, (int)dims[ax], nout[ax], inner, idx[ax], w[ax], s);
    if (err != cudaSuccess) return err;
    ++*launched;
    dims[ax] = nout[ax];
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// in (C, zin, yin, xin) and out (C, zout, yout, xout), contiguous float32; `plan` the
// int64 array of ops/separable_resample.py::_launch_args: route (0 fused, 1 axes), C,
// the input and output extents, taps, contractions, their axes (3), the fused route's
// tile (3), tiles (3), band (3), vec, shared-memory offsets (3: first and second
// contraction, taps) and bytes, then per axis the band starts, tap indices and weights
// (device pointers; 0 for an identity axis).
// tmp1 and tmp2 hold the axes route's first and second intermediates. Launches on
// `stream` without synchronising; writes the number of CUDA launches to *launched and
// returns a cudaError_t (0 on success).
extern "C" int monai_separable_resample_3d(const void* in, void* out, void* tmp1, void* tmp2, const long long* plan,
                                           void* stream, int* launched) {
  *launched = 0;
  if (plan[1] <= 0) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < 6; ++d)
    if (plan[2 + d] <= 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (plan[8]) {
    case 1: return (int)cleared(run<1>(in, out, tmp1, tmp2, plan, s, launched));
    case 2: return (int)cleared(run<2>(in, out, tmp1, tmp2, plan, s, launched));
    case 4: return (int)cleared(run<4>(in, out, tmp1, tmp2, plan, s, launched));
    default: return (int)cudaErrorInvalidValue;
  }
}
