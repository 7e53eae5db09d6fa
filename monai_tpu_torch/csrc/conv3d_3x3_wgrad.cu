// The weight gradient of the 3x3x3, stride-1, SAME (zero-padded) 3-D convolution,
// channels-last:
//
//   dw[kd,kh,kw,ci,co] = sum_{n,d,h,w} x[n,d+kd-1,h+kh-1,w+kw-1,ci] * g[n,d,h,w,co]
//
// x (N,D,H,W,CI) and g (N,D,H,W,CO) are contiguous, float32, bfloat16 or float16, of one
// type; dw (3,3,3,CI,CO) is written in that type from float32 sums.
//
// Replaces the dw half of monai_tpu/ops/pallas_conv3d.py::_conv3d_bwd_rule, which XLA
// runs there as a correlation of x with g (the dx half is the forward kernel on the
// flipped weights, csrc/conv3d_3x3_same.cu).
//
// What bounds it on the card: it is a contraction over K = N*D*H*W voxels (3.5 M at the
// UNet's 96^3 level at batch 4) into a small output, 27*CI*CO values (108 at 2 -> 2, 1.8 M
// at 256 -> 256). The wide shallow layers are bound by the bytes (x and g read once),
// the deep ones by the operations (2*27*K*CI*CO). So no block can own an output tile
// and walk K alone. The design:
//
// - Split K into chunks of bricks (a brick: up to 128 voxels of g in one image, the shape
//   picked on the host). A block owns one chunk and one (CI tile, CO tile) of all 27
//   taps, and writes its float32 partial sums; a second launch adds the chunks' partials
//   in chunk order. No atomics, so dw is the same bits from run to run.
// - Per brick, the block stages g's rows and x's brick plus its one-voxel halo in shared
//   memory once for all 27 taps: a tap's rows of x are the halo rows at the tap's offset.
// - bfloat16 and float16 with CI and CO multiples of 8 and 16-byte aligned x and g run on
//   the tensor cores by mma.sync.m16n8k16 (f32 accumulate), nine warps, one (kd, kh) row
//   of three taps each: M = the CI tile (16 or 32), N = the CO tile (8, 16 or 32), K = the
//   brick's voxels 16 at a time. x and g are staged by cp.async, two bricks deep; the A
//   (x^T) and B (g) fragments come by ldmatrix.trans from rows padded by 16 bytes, so that
//   eight consecutive rows fall in eight bank groups. A warp's B fragments serve its three
//   taps.
// - Everything else (float32, CI or CO not a multiple of 8 or of 1 and 2 channels, an
//   unaligned pointer) runs on the FMA units in full float32 (no TF32): the brick and halo
//   are staged as float32, a thread owns one tap and a register tile of RC x RO channels
//   (RC = CI and RO = CO where they are 1 or 2, so the UNet's 2 -> 2 layer pads no lane),
//   and the block's row groups, where a tile is small, add their sums in a fixed order.
//
// Left for later: TMA and wgmma, a persistent grid that keeps a chunk's partials on chip,
// and a wider tile at the deep layers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int kRows = 128;     // voxels of g a brick, at most
constexpr int kMaxHalo = 640;  // voxels of a brick's halo, at most
constexpr int kMmaThreads = 288;  // nine warps, three taps each
constexpr int kMaxFmaThreads = 512;

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// The bricks of a launch and its chunks, computed on the host.
struct Geom {
  int D, H, W, CI, CO;
  int bd, bh, bw;     // brick extents
  int nbd, nbh, nbw;  // bricks along each axis of one image
  int hh, hw;         // halo extents along h and w: bh + 2, bw + 2
  int halo;           // (bd + 2) * hh * hw
  int rows;           // bd * bh * bw, the brick's voxels
  long long bricks;   // N * nbd * nbh * nbw
  long long per_chunk;  // bricks a chunk (the last may have fewer)
  int tiles_ci;       // CI tiles; blockIdx.x = co tile * tiles_ci + ci tile
};

__device__ __forceinline__ void brick_origin(const Geom& g, long long b, long long& n, int& d0, int& h0, int& w0) {
  const int iw = (int)(b % g.nbw);
  b /= g.nbw;
  const int ih = (int)(b % g.nbh);
  b /= g.nbh;
  const int id = (int)(b % g.nbd);
  n = b / g.nbd;
  d0 = id * g.bd, h0 = ih * g.bh, w0 = iw * g.bw;
}

// The voxel of halo place v of the brick at (n, d0, h0, w0), or -1 outside the volume.
__device__ __forceinline__ long long halo_voxel(const Geom& g, long long n, int d0, int h0, int w0, int v) {
  const int hhw = g.hh * g.hw;
  const int vd = v / hhw, vr = v - vd * hhw, vh = vr / g.hw, vw = vr - vh * g.hw;
  const int d = d0 - 1 + vd, h = h0 - 1 + vh, w = w0 - 1 + vw;
  const bool in = (unsigned)d < (unsigned)g.D && (unsigned)h < (unsigned)g.H && (unsigned)w < (unsigned)g.W;
  return in ? ((n * g.D + d) * g.H + h) * (long long)g.W + w : -1;
}

// The voxel of brick row r, or -1 past the brick or the volume.
__device__ __forceinline__ long long row_voxel(const Geom& g, long long n, int d0, int h0, int w0, int r) {
  const int bhw = g.bh * g.bw;
  const int rd = r / bhw, rr = r - rd * bhw, rh = rr / g.bw, rw = rr - rh * g.bw;
  const int d = d0 + rd, h = h0 + rh, w = w0 + rw;
  return rd < g.bd && d < g.D && h < g.H && w < g.W ? ((n * g.D + d) * g.H + h) * (long long)g.W + w : -1;
}

// A brick row's place in the halo (0 for rows past the brick, whose g is zero) and each
// tap's offset there; the same for every brick of a launch.
__device__ __forceinline__ void brick_tables(const Geom& g, int* row_halo, int* tap_off) {
  const int bhw = g.bh * g.bw;
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const int rd = r / bhw, rr = r - rd * bhw, rh = rr / g.bw, rw = rr - rh * g.bw;
    row_halo[r] = r < g.rows ? (rd * g.hh + rh) * g.hw + rw : 0;
  }
  if (threadIdx.x < 27) {
    const int t = threadIdx.x;
    tap_off[t] = (t / 9) * g.hh * g.hw + ((t / 3) % 3) * g.hw + t % 3;
  }
}

// Tensor cores: a (16 MT) x (8 NT) tile of (ci, co) for all 27 taps over one chunk of
// bricks. Shared memory: two stages of [halo][CIt + 8] x and [kRows][COt + 8] g, a stage's
// x part xs_bytes (rounded up to 128 bytes).
template <typename T, int MT, int NT>
__global__ void __launch_bounds__(kMmaThreads)
conv3d_wgrad_mma_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ partial, Geom g,
                        int xs_bytes) {
  constexpr int CIt = 16 * MT, COt = 8 * NT, XLD = CIt + 8, GLD = COt + 8;
  constexpr int kGBytes = kRows * GLD * (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ int row_halo[kRows];
  __shared__ int tap_off[27];
  brick_tables(g, row_halo, tap_off);

  const int ci0 = (blockIdx.x % g.tiles_ci) * CIt, co0 = (blockIdx.x / g.tiles_ci) * COt;
  const long long b0 = (long long)blockIdx.y * g.per_chunk;
  const long long b1 = b0 + g.per_chunk < g.bricks ? b0 + g.per_chunk : g.bricks;
  const int stage_bytes = xs_bytes + kGBytes;
  auto xs = [&](int s) { return reinterpret_cast<T*>(dyn + s * stage_bytes); };
  auto gs = [&](int s) { return reinterpret_cast<T*>(dyn + s * stage_bytes + xs_bytes); };
  auto load = [&](long long b, int s) {
    long long n;
    int d0, h0, w0;
    brick_origin(g, b, n, d0, h0, w0);
    T* xd = xs(s);
    constexpr int XC = CIt / 8;  // 16-byte copies a halo voxel
    for (int i = threadIdx.x; i < g.halo * XC; i += blockDim.x) {
      const int v = i / XC, c = (i - v * XC) * 8;
      const long long src = halo_voxel(g, n, d0, h0, w0, v);
      const bool ok = src >= 0 && ci0 + c < g.CI;
      cp_async16(xd + v * XLD + c, ok ? x + src * g.CI + ci0 + c : x, ok ? 16 : 0);
    }
    T* gd = gs(s);
    constexpr int GC = COt / 8;
    for (int i = threadIdx.x; i < kRows * GC; i += blockDim.x) {
      const int r = i / GC, c = (i - r * GC) * 8;
      const long long src = row_voxel(g, n, d0, h0, w0, r);
      const bool ok = src >= 0 && co0 + c < g.CO;
      cp_async16(gd + r * GLD + c, ok ? gy + src * g.CO + co0 + c : gy, ok ? 16 : 0);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[3][MT][NT][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][i][j][q] = 0.0f;

  if (b0 < b1) load(b0, 0);
  cp_async_commit();
  __syncthreads();  // the tables
  int toff[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) toff[t] = tap_off[warp * 3 + t];
  const int k_steps = (g.rows + 15) / 16;
  for (long long b = b0; b < b1; ++b) {
    const int s = (int)((b - b0) & 1);
    if (b + 1 < b1) {
      load(b + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xd = xs(s);
    const T* gd = gs(s);
    for (int ks = 0; ks < k_steps; ++ks) {
      const int k0 = ks * 16;
      unsigned bf[NT][2];
      const T* grow = gd + (k0 + lane % 16) * GLD;
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2)
        ldsm_x4_t(bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1], grow + (j + lane / 16) * 8);
      if (NT % 2) ldsm_x2_t(bf[NT - 1][0], bf[NT - 1][1], grow + (NT - 1) * 8);
      // A = x^T: lanes 0-7 / 16-23 address rows k0 + 0..7 / k0 + 8..15 at channels 0-7,
      // lanes 8-15 / 24-31 the same rows at channels 8-15
      const int rh = row_halo[k0 + lane % 8 + (lane / 16) * 8];
      const int cofs = ((lane / 8) % 2) * 8;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const T* arow = xd + (rh + toff[t]) * XLD + cofs;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned a[4];
          ldsm_x4_t(a[0], a[1], a[2], a[3], arow + i * 16);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_k16<T>(acc[t][i][j], a, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration
  }

  // c0, c1: row lane / 4, columns 2 (lane % 4) + 0, 1; c2, c3: the same 8 rows further
  const int gid = lane / 4, tq = lane % 4;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* out = partial + ((long long)blockIdx.y * 27 + warp * 3 + t) * g.CI * g.CO;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ci = ci0 + i * 16 + gid + (q / 2) * 8, co = co0 + j * 8 + tq * 2 + q % 2;
          if (ci < g.CI && co < g.CO) out[(long long)ci * g.CO + co] = acc[t][i][j][q];
        }
  }
}

// FMA units, full float32: a (RC pci) x (RO pco) tile of (ci, co) for all 27 taps over
// one chunk of bricks. Thread t owns tap t % 27, channel group (t / 27) % (pci pco) and
// row group t / (27 pci pco) of R. Shared memory: [halo][CIt] x and [kRows][COt] g as
// float32, then the row groups' sums.
template <typename T, int RC, int RO>
__global__ void __launch_bounds__(kMaxFmaThreads)
conv3d_wgrad_fma_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ partial, Geom g,
                        int pci, int pco, int R) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ int row_halo[kRows];
  __shared__ int tap_off[27];
  brick_tables(g, row_halo, tap_off);
  const int CIt = RC * pci, COt = RO * pco;
  float* xs = fsm;
  float* gs = fsm + g.halo * CIt;
  const int tid = threadIdx.x, per_rg = 27 * pci * pco;
  const int tap = tid % 27, oc = (tid / 27) % (pci * pco), rg = tid / per_rg;
  const int pi = oc % pci, po = oc / pci;
  const int ci0 = (blockIdx.x % g.tiles_ci) * CIt, co0 = (blockIdx.x / g.tiles_ci) * COt;
  const long long b0 = (long long)blockIdx.y * g.per_chunk;
  const long long b1 = b0 + g.per_chunk < g.bricks ? b0 + g.per_chunk : g.bricks;
  float acc[RC][RO];
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[i][j] = 0.0f;
  __syncthreads();  // the tables
  const int off = tap_off[tap];

  for (long long b = b0; b < b1; ++b) {
    long long n;
    int d0, h0, w0;
    brick_origin(g, b, n, d0, h0, w0);
    for (int v = tid; v < g.halo; v += blockDim.x) {
      const long long src = halo_voxel(g, n, d0, h0, w0, v);
      for (int c = 0; c < CIt; ++c)
        xs[v * CIt + c] = src >= 0 && ci0 + c < g.CI ? to_float(x[src * g.CI + ci0 + c]) : 0.0f;
    }
    for (int r = tid; r < kRows; r += blockDim.x) {
      const long long src = row_voxel(g, n, d0, h0, w0, r);
      for (int c = 0; c < COt; ++c)
        gs[r * COt + c] = src >= 0 && co0 + c < g.CO ? to_float(gy[src * g.CO + co0 + c]) : 0.0f;
    }
    __syncthreads();
    for (int r = rg; r < g.rows; r += R) {
      const float* xp = xs + (row_halo[r] + off) * CIt + pi * RC;
      const float* gp = gs + r * COt + po * RO;
      float xv[RC], gv[RO];
#pragma unroll
      for (int i = 0; i < RC; ++i) xv[i] = xp[i];
#pragma unroll
      for (int j = 0; j < RO; ++j) gv[j] = gp[j];
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int j = 0; j < RO; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
    }
    __syncthreads();  // the staged brick is read; the next one may overwrite it
  }

  // the row groups' sums, added in row-group order by the threads of group 0
  float* red = fsm;
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) red[tid * RC * RO + i * RO + j] = acc[i][j];
  __syncthreads();
  if (rg != 0) return;
  float* out = partial + ((long long)blockIdx.y * 27 + tap) * g.CI * g.CO;
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      float sum = 0.0f;
      for (int q = 0; q < R; ++q) sum += red[(q * per_rg + tid) * RC * RO + i * RO + j];
      const int ci = ci0 + pi * RC + i, co = co0 + po * RO + j;
      if (ci < g.CI && co < g.CO) out[(long long)ci * g.CO + co] = sum;
    }
}

// dw = the chunks' partials added in chunk order, rounded once to T.
template <typename T>
__global__ void __launch_bounds__(256)
conv3d_wgrad_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, long long n, int chunks) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int c = 0; c < chunks; ++c) sum += partial[(long long)c * n + e];
  dw[e] = from_float<T>(sum);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The brick of up to kRows voxels whose halo fits kMaxHalo with the least work over the
// volume, counted as brick rows plus halo voxels loaded.
Geom make_geom(long long N, int D, int H, int W, int CI, int CO) {
  Geom g{D, H, W, CI, CO};
  long long best = -1;
  for (int bw = 1; bw <= W && bw <= 32; ++bw)
    for (int bh = 1; bh <= H && bh <= 32 && bw * bh <= kRows; ++bh) {
      int bd = D < kRows / (bw * bh) ? D : kRows / (bw * bh);
      while (bd > 1 && (bd + 2) * (bh + 2) * (bw + 2) > kMaxHalo) --bd;
      const int halo = (bd + 2) * (bh + 2) * (bw + 2);
      if (halo > kMaxHalo) continue;
      const long long nb = N * cdiv(D, bd) * cdiv(H, bh) * cdiv(W, bw);
      const long long cost = nb * (kRows + halo);
      if (best < 0 || cost < best || (cost == best && bw > g.bw)) {
        best = cost;
        g.bricks = nb;
        g.bd = bd, g.bh = bh, g.bw = bw;
      }
    }
  g.nbd = (int)cdiv(D, g.bd), g.nbh = (int)cdiv(H, g.bh), g.nbw = (int)cdiv(W, g.bw);
  g.hh = g.bh + 2, g.hw = g.bw + 2;
  g.halo = (g.bd + 2) * g.hh * g.hw;
  g.rows = g.bd * g.bh * g.bw;
  return g;
}

// One launch, worked out once for each device, dtype, alignment and shape.
struct Plan {
  cudaError_t (*run)(const Plan&, const void* x, const void* g, float* partial, cudaStream_t);
  Geom g;
  dim3 grid;
  int threads, xs_bytes, pci, pco, R, route;  // route: 0 tensor cores, 1 FMA
  size_t smem;
  int chunks;
};

template <typename T, int MT, int NT>
cudaError_t run_mma(const Plan& p, const void* x, const void* g, float* partial, cudaStream_t s) {
  conv3d_wgrad_mma_kernel<T, MT, NT><<<p.grid, kMmaThreads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, p.g, p.xs_bytes);
  return cudaGetLastError();
}

template <typename T, int RC, int RO>
cudaError_t run_fma(const Plan& p, const void* x, const void* g, float* partial, cudaStream_t s) {
  conv3d_wgrad_fma_kernel<T, RC, RO><<<p.grid, p.threads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, p.g, p.pci, p.pco, p.R);
  return cudaGetLastError();
}

// Opt the kernel in to the most dynamic shared memory any plan of it takes (so that every
// cached plan's launch fits, whatever plan came last) and split K into as many chunks as
// fill the card once with the launch's tiles.
template <typename K>
cudaError_t finish_plan(Plan& p, K* kernel, size_t most_smem, long long tiles) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most_smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long chunks = cdiv((long long)sms * per_sm, tiles);
  if (chunks > p.g.bricks) chunks = p.g.bricks;
  if (chunks < 1) chunks = 1;
  p.g.per_chunk = cdiv(p.g.bricks, chunks);
  p.chunks = (int)cdiv(p.g.bricks, p.g.per_chunk);
  p.grid = dim3((unsigned)tiles, (unsigned)p.chunks);
  return cudaSuccess;
}

template <typename T, int MT, int NT>
cudaError_t plan_mma(Plan& p) {
  constexpr int CIt = 16 * MT, COt = 8 * NT;
  p.route = 0;
  p.run = run_mma<T, MT, NT>;
  p.threads = kMmaThreads;
  auto xs_bytes = [](int halo) { return (halo * (CIt + 8) * (int)sizeof(T) + 127) / 128 * 128; };
  auto stage = [&](int halo) { return (size_t)xs_bytes(halo) + (size_t)kRows * (COt + 8) * sizeof(T); };
  p.xs_bytes = xs_bytes(p.g.halo);
  p.smem = 2 * stage(p.g.halo);
  p.g.tiles_ci = (int)cdiv(p.g.CI, CIt);
  return finish_plan(p, conv3d_wgrad_mma_kernel<T, MT, NT>, 2 * stage(kMaxHalo), p.g.tiles_ci * cdiv(p.g.CO, COt));
}

template <typename T, int RC, int RO>
cudaError_t plan_fma(Plan& p) {
  p.route = 1;
  p.run = run_fma<T, RC, RO>;
  p.pci = (int)(cdiv(p.g.CI, RC) < 4 ? cdiv(p.g.CI, RC) : 4);
  p.pco = (int)(cdiv(p.g.CO, RO) < 4 ? cdiv(p.g.CO, RO) : 4);
  const int per_rg = 27 * p.pci * p.pco;
  p.R = 256 / per_rg > 1 ? 256 / per_rg : 1;
  p.threads = per_rg * p.R;
  const int CIt = RC * p.pci, COt = RO * p.pco;
  auto floats = [](size_t halo, size_t cit, size_t cot, size_t threads) {
    const size_t staged = halo * cit + kRows * cot, red = threads * RC * RO;
    return 4 * (staged > red ? staged : red);
  };
  p.smem = floats(p.g.halo, CIt, COt, p.threads);
  p.g.tiles_ci = (int)cdiv(p.g.CI, CIt);
  return finish_plan(p, conv3d_wgrad_fma_kernel<T, RC, RO>, floats(kMaxHalo, 4 * RC, 4 * RO, kMaxFmaThreads),
                     p.g.tiles_ci * cdiv(p.g.CO, COt));
}

template <typename T, int RC>
cudaError_t plan_fma_ro(Plan& p) {
  if (p.g.CO == 1) return plan_fma<T, RC, 1>(p);
  if (p.g.CO == 2) return plan_fma<T, RC, 2>(p);
  return plan_fma<T, RC, 4>(p);
}

template <typename T>
cudaError_t plan_fma_rc(Plan& p) {
  if (p.g.CI == 1) return plan_fma_ro<T, 1>(p);
  if (p.g.CI == 2) return plan_fma_ro<T, 2>(p);
  return plan_fma_ro<T, 4>(p);
}

template <typename T>
cudaError_t plan_mma_tile(Plan& p) {
  const bool m2 = p.g.CI % 32 == 0;
  if (p.g.CO % 32 == 0) return m2 ? plan_mma<T, 2, 4>(p) : plan_mma<T, 1, 4>(p);
  if (p.g.CO % 16 == 0) return m2 ? plan_mma<T, 2, 2>(p) : plan_mma<T, 1, 2>(p);
  return m2 ? plan_mma<T, 2, 1>(p) : plan_mma<T, 1, 1>(p);
}

cudaError_t make_plan(Plan& p, int dtype, bool aligned, long long N, int D, int H, int W, int CI, int CO) {
  p.g = make_geom(N, D, H, W, CI, CO);
  if (p.g.bricks <= 0) return cudaErrorInvalidValue;
  const bool mma = dtype != 0 && aligned && CI % 8 == 0 && CO % 8 == 0;
  if (dtype == 0) return plan_fma_rc<float>(p);
  if (dtype == 1) return mma ? plan_mma_tile<__nv_bfloat16>(p) : plan_fma_rc<__nv_bfloat16>(p);
  return mma ? plan_mma_tile<__half>(p) : plan_fma_rc<__half>(p);
}

cudaError_t find_plan(Plan& p, int dtype, bool aligned, long long N, int D, int H, int W, int CI, int CO) {
  static std::mutex mu;
  static std::map<std::array<long long, 9>, Plan> plans;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<long long, 9> key{dev, dtype, aligned, N, D, H, W, CI, CO};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    p = it->second;
    return cudaSuccess;
  }
  const cudaError_t made = make_plan(p, dtype, aligned, N, D, H, W, CI, CO);
  if (made == cudaSuccess) plans.emplace(key, p);
  return made;
}

bool valid(long long n, int d, int h, int w, int ci, int co, int dtype) {
  return n > 0 && d > 0 && h > 0 && w > 0 && ci > 0 && co > 0 && dtype >= 0 && dtype <= 2 &&
         (long long)d * h * w <= 0x7fffffffLL && 27LL * ci * co <= 0x7fffffffLL;
}

}  // namespace

// The plan of a launch on the current device, into out[0..4]: the route (0 tensor cores,
// 1 FMA), the K chunks, the float32 partials the caller provides (chunks x 27 x CI x CO),
// the blocks of the first launch and its threads. aligned: x and g are 16-byte aligned.
// Returns a cudaError_t.
extern "C" int monai_conv3d_3x3_wgrad_plan(long long n, int d, int h, int w, int ci, int co, int dtype, int aligned,
                                           long long* out) {
  if (!valid(n, d, h, w, ci, co, dtype)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = find_plan(p, dtype, aligned != 0, n, d, h, w, ci, co);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.route;
  out[1] = p.chunks;
  out[2] = (long long)p.chunks * 27 * ci * co;
  out[3] = (long long)p.grid.x * p.grid.y;
  out[4] = p.threads;
  return 0;
}

// dw (3,3,3,CI,CO) from x (N,D,H,W,CI) and g (N,D,H,W,CO); partial holds the plan's
// float32 partial sums (monai_conv3d_3x3_wgrad_plan, out[2]). dtype: 0 float32, 1
// bfloat16, 2 float16. Two launches on `stream`, no synchronisation. Returns a
// cudaError_t (0 on success).
extern "C" int monai_conv3d_3x3_wgrad(const void* x, const void* g, void* dw, float* partial, long long n, int d,
                                      int h, int w, int ci, int co, int dtype, void* stream) {
  if (!valid(n, d, h, w, ci, co, dtype) || partial == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = find_plan(p, dtype, aligned16(x) && aligned16(g), n, d, h, w, ci, co);
  if (err != cudaSuccess) return (int)err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = p.run(p, x, g, partial, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = 27LL * ci * co;
  const unsigned blocks = (unsigned)cdiv(total, 256);
  if (dtype == 0)
    conv3d_wgrad_reduce_kernel<float><<<blocks, 256, 0, s>>>(partial, static_cast<float*>(dw), total, p.chunks);
  else if (dtype == 1)
    conv3d_wgrad_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(partial, static_cast<__nv_bfloat16*>(dw),
                                                                      total, p.chunks);
  else
    conv3d_wgrad_reduce_kernel<__half><<<blocks, 256, 0, s>>>(partial, static_cast<__half*>(dw), total, p.chunks);
  return (int)cudaGetLastError();
}
