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
// What bounds it on the card: it is a contraction over K = N*D*H*W voxels (3.5 M at 96^3,
// batch 4) into a small output, 27*CI*CO values (108 at 2 -> 2, 1.8 M at 256 -> 256). At 1
// and 2 channels it is bound by the bytes (x and g read once); from about 8 channels on by
// the operations, 2*27*K*CI*CO: on the tensor cores in bfloat16 and float16, on the FMA
// units in float32 (67 TFLOP/s), where the float32 SwinUNETR step spends most of its time.
// So no block can own an output tile and walk K alone:
//
// - K is split into chunks of bricks (each route has its own). A block owns one
//   chunk and one (CI tile, CO tile) of all 27 taps and writes its float32 partial sums;
//   a second launch adds the chunks' partials in a fixed order (each thread a strided
//   set of chunks, then the threads in order). No atomics, so dw is the same bits from run
//   to run. With one chunk the block writes dw itself and there is no second launch.
// - Three routes, picked on the host (make_plan; ops/conv3d.py::wgrad_plan mirrors it):
//
//   mma   bfloat16 and float16 with CI and CO multiples of 8 and 16-byte aligned x and g.
//         Per brick (up to 128 voxels of g in one image) x's brick and its one-voxel halo
//         and g's rows are staged by cp.async, two bricks deep, in rows padded by 16 bytes;
//         nine warps, one (kd, kh) row of three taps each, run mma.sync.m16n8k16 (f32
//         accumulate) with M = the CI tile (16 or 32), N = the CO tile (8, 16 or 32), K = the
//         brick's voxels 16 at a time, both fragments by ldmatrix.trans.
//   fma   everything else but the smallest channel counts, in full float32 (no TF32). Each
//         (kd, kh) row of taps is a GEMM of M = the CI tile, N = the CO tile, K = the voxels.
//         A thread owns one (kd, kh) row, all three kw taps and an RC x RO register tile of
//         (ci, co) (4 x 4 from 3 channels on): it walks a line of the brick along w, and at
//         each voxel loads one x vector (RC) and one g vector (RO) from shared memory by 128-
//         or 64-bit loads and multiplies the x vectors of w - 1, w and w + 1, kept in
//         registers as they roll by, into the three taps' accumulators: 3 RC RO FMAs for RC +
//         RO words (6 a word at 4 x 4). The threads of a row read one voxel's contiguous
//         channels of x, and g's are broadcasts, so each load takes one or two wavefronts.
//         432 threads: 9 rows x 48 channel groups (a CI tile of 16 and a CO tile of 48), or
//         rows split over more lines where the tiles are narrow (their sums added in a fixed
//         order); ~120 registers, one block an SM. Float32 x and g are staged by cp.async (16
//         bytes where CI, or CO, is a multiple of 4 and the pointers aligned, else 4), two
//         bricks deep, so that the next brick loads while this one computes; bfloat16 and
//         float16 are widened to float32 as they are staged. Bricks: lines of up to 32 voxels,
//         up to 256 voxels, two stages in 216 KB. (On the H100 a 4 x 8 tile, 216 threads and
//         ~210 registers reached 43% of the FMA rate at 48 -> 48 96^3, two such blocks an SM
//         at 144 registers spilled and reached 42%, and this layout 51%.)
//   small CI and CO of 1 or 2 (the UNet's 2 -> 2 layer), bound by the bytes: no staging. A
//         brick is a strip of 32 columns by up to 24 rows of one plane; a warp takes one kd
//         and walks the strip's rows, a column a lane, keeping the x rows h - 1, h, h + 1 of
//         its plane (the columns beside its own by shuffles) and the 9 taps x CI x CO of its
//         kd in registers, and loading x and g two to four rows ahead from global memory. The
//         block adds its threads' sums by a fixed shuffle tree and then over its warps in
//         order. (0.08 ms at the bf16 2 -> 2 96^3 site on the H100, against 0.0085 for the
//         bytes: each row's loads, shuffles and address arithmetic, not the bytes, bound it.)
//
// Left for later: TMA and wgmma for the tensor-core route; 3xTF32 on the tensor cores for
// float32 (the port's float32 is full precision today); a persistent grid that keeps a
// chunk's partials on chip; the deep float32 sites (6^3 and 3^3, K of 864 and 108 voxels),
// where the partials and each block's fixed costs weigh more than the FMAs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>

#include "mma_sync.cuh"
#include "runtime_error.cuh"

namespace {

constexpr int kRows = 128;        // mma route: voxels of g a brick, at most
constexpr int kMaxHalo = 640;     // mma route: voxels of a brick's halo, at most
constexpr int kMmaThreads = 288;  // nine warps, three taps each
constexpr int kFmaThreads = 432;  // fma route: threads a block, at most
constexpr int kFmaGroups = 48;    // fma route: channel groups (pci x pco) a block, at most
constexpr int kFmaMaxPco = 12;    // fma route: CO groups a block, at most
constexpr int kFmaMaxCit = 32;    // fma route: the CI tile, at most
constexpr int kFmaLine = 32;      // fma route: brick extent along w, at most
constexpr int kFmaMaxRows = 256;  // fma route: brick voxels, at most
constexpr int kFmaStageBytes = 110592;  // fma route: a stage (x halo and g rows), at most
constexpr int kFmaBrickCost = 2048;    // fma route: a brick's fixed cost, in staged floats
constexpr int kSmallSlots = 4;        // small route: bricks a block walks at once
constexpr int kSmallThreads = 96 * kSmallSlots;  // small route: a warp a brick and kd
constexpr int kSmallRows = 24;        // small route: brick rows (h), at most
constexpr int kSmallAhead = 4;        // small route: rows of x and g loaded ahead (16-bit types)

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// 4 bytes from global to shared memory; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// The bricks of a launch and its chunks, computed on the host.
struct Geom {
  int D, H, W, CI, CO;
  int bd, bh, bw;     // brick extents
  int nbd, nbh, nbw;  // bricks along each axis of one image
  int hh, hw;         // halo extents along h and w: bh + 2, bw + 2
  int halo;           // (bd + 2) * hh * hw
  int rows;           // bd * bh * bw, the brick's voxels
  long long bricks;   // N * nbd * nbh * nbw
  long long per_chunk;  // bricks a chunk; the last may have fewer
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

// Where a block's sums go: into dw (rounded to T) where the launch has one chunk, else into
// its chunk's float32 partials; e = (tap CI + ci) CO + co.
template <typename T>
struct Out {
  float* partial;
  T* dw;
  bool direct;
  __device__ __forceinline__ Out(float* p, T* d, const Geom& g)
      : partial(p + (long long)blockIdx.y * 27 * g.CI * g.CO), dw(d), direct(gridDim.y == 1) {}
  __device__ __forceinline__ void put(long long e, float v) const {
    if (direct)
      dw[e] = from_float<T>(v);
    else
      partial[e] = v;
  }
};

// Tensor cores: a (16 MT) x (8 NT) tile of (ci, co) for all 27 taps over one chunk of
// bricks. Shared memory: two stages of [halo][CIt + 8] x and [kRows][COt + 8] g, a stage's
// x part xs_bytes (rounded up to 128 bytes).
template <typename T, int MT, int NT>
__global__ void __launch_bounds__(kMmaThreads)
conv3d_wgrad_mma_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ partial,
                        T* __restrict__ dw, Geom g, int xs_bytes) {
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
  const Out<T> out(partial, dw, g);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const long long tap = (long long)(warp * 3 + t) * g.CI * g.CO;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ci = ci0 + i * 16 + gid + (q / 2) * 8, co = co0 + j * 8 + tq * 2 + q % 2;
          if (ci < g.CI && co < g.CO) out.put(tap + ci * g.CO + co, acc[t][i][j][q]);
        }
  }
}

// R consecutive floats from shared memory into registers, 16 or 8 bytes a load.
template <int R>
__device__ __forceinline__ void lds(float (&v)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      v[q] = t.x, v[q + 1] = t.y, v[q + 2] = t.z, v[q + 3] = t.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int q = 0; q < R; q += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + q);
      v[q] = t.x, v[q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = p[q];
  }
}

// FMA units, full float32: a (RC pci) x (RO pco) tile of (ci, co) for all 27 taps over one
// chunk of bricks. Thread t owns channel group t % (pci pco) (ci group fastest), (kd, kh)
// row (t / (pci pco)) % 9 with its three kw taps, and the brick lines l = split, split +
// splits, ... with split = t / (9 pci pco). Shared memory: two stages of [halo][CIt] x and
// [rows][COt] g as float32, the g part at gs_off floats into a stage of stage_floats; then
// the splits' sums. vec: float32 x (bit 0) and g (bit 1) staged 16 bytes a copy.
template <typename T, int RC, int RO>
__global__ void __launch_bounds__(kFmaThreads)
conv3d_wgrad_fma_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ partial,
                        T* __restrict__ dw, Geom g, int pci, int pco, int splits, int gs_off, int stage_floats,
                        int vec) {
  extern __shared__ __align__(16) float fsm[];
  const int CIt = RC * pci, COt = RO * pco, P = pci * pco, nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int combo = tid % P, row9 = (tid / P) % 9, split = tid / (9 * P);
  const int pi = combo % pci, po = combo / pci, kd = row9 / 3, kh = row9 % 3;
  const int ci0 = (blockIdx.x % g.tiles_ci) * CIt, co0 = (blockIdx.x / g.tiles_ci) * COt;
  const long long b0 = (long long)blockIdx.y * g.per_chunk;
  const long long b1 = b0 + g.per_chunk < g.bricks ? b0 + g.per_chunk : g.bricks;

  // stage s <- the brick at (n, d0, h0, w0)
  auto load = [&](long long n, int d0, int h0, int w0, int s) {
    float* xd = fsm + s * stage_floats;
    float* gd = xd + gs_off;
    if constexpr (std::is_same<T, float>::value) {
      if (vec & 1) {  // CI a multiple of 4, x 16-byte aligned
        const int XC = CIt / 4;
        for (int i = tid; i < g.halo * XC; i += nthreads) {
          const int v = i / XC, c = (i - v * XC) * 4;
          const long long src = halo_voxel(g, n, d0, h0, w0, v);
          const bool ok = src >= 0 && ci0 + c < g.CI;
          cp_async16(xd + v * CIt + c, ok ? x + src * g.CI + ci0 + c : x, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < g.halo * CIt; i += nthreads) {
          const int v = i / CIt, c = i - v * CIt;
          const long long src = halo_voxel(g, n, d0, h0, w0, v);
          const bool ok = src >= 0 && ci0 + c < g.CI;
          cp_async4(xd + i, ok ? x + src * g.CI + ci0 + c : x, ok ? 4 : 0);
        }
      }
      if (vec & 2) {  // CO a multiple of 4, g 16-byte aligned
        const int GC = COt / 4;
        for (int i = tid; i < g.rows * GC; i += nthreads) {
          const int r = i / GC, c = (i - r * GC) * 4;
          const long long src = row_voxel(g, n, d0, h0, w0, r);
          const bool ok = src >= 0 && co0 + c < g.CO;
          cp_async16(gd + r * COt + c, ok ? gy + src * g.CO + co0 + c : gy, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < g.rows * COt; i += nthreads) {
          const int r = i / COt, c = i - r * COt;
          const long long src = row_voxel(g, n, d0, h0, w0, r);
          const bool ok = src >= 0 && co0 + c < g.CO;
          cp_async4(gd + i, ok ? gy + src * g.CO + co0 + c : gy, ok ? 4 : 0);
        }
      }
    } else {  // 16-bit types: widened to float32 as they are staged
      for (int i = tid; i < g.halo * CIt; i += nthreads) {
        const int v = i / CIt, c = i - v * CIt;
        const long long src = halo_voxel(g, n, d0, h0, w0, v);
        xd[i] = src >= 0 && ci0 + c < g.CI ? to_float(x[src * g.CI + ci0 + c]) : 0.0f;
      }
      for (int i = tid; i < g.rows * COt; i += nthreads) {
        const int r = i / COt, c = i - r * COt;
        const long long src = row_voxel(g, n, d0, h0, w0, r);
        gd[i] = src >= 0 && co0 + c < g.CO ? to_float(gy[src * g.CO + co0 + c]) : 0.0f;
      }
    }
  };

  float acc[3][RC][RO];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < RO; ++j) acc[k][i][j] = 0.0f;

  // One voxel w of a line: x2 <- x at w + 1 (halo place w + 2), then the taps kw = 0, 1, 2
  // take the x of w - 1, w and w + 1 (x0, x1, x2) times g at w. (Loading the next voxel's x
  // and g a step ahead by hand ran 9% slower on the H100: ptxas schedules these loads
  // better itself.)
  auto step = [&](const float (&x0)[RC], const float (&x1)[RC], float (&x2)[RC], const float* xp, const float* gp) {
    float gv[RO];
    lds(x2, xp);
    lds(gv, gp);
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < RO; ++j) {
        acc[0][i][j] = fmaf(x0[i], gv[j], acc[0][i][j]);
        acc[1][i][j] = fmaf(x1[i], gv[j], acc[1][i][j]);
        acc[2][i][j] = fmaf(x2[i], gv[j], acc[2][i][j]);
      }
  };

  long long n = 0, n1 = 0;  // the origins of this brick and the next
  int d0 = 0, h0 = 0, w0 = 0, d1 = 0, h1 = 0, w1 = 0;
  if (b0 < b1) {
    brick_origin(g, b0, n, d0, h0, w0);
    load(n, d0, h0, w0, 0);
  }
  cp_async_commit();
  for (long long b = b0; b < b1; ++b) {
    const int s = (int)((b - b0) & 1);
    if (b + 1 < b1) {
      brick_origin(g, b + 1, n1, d1, h1, w1);
      load(n1, d1, h1, w1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nd = min(g.bd, g.D - d0), nh = min(g.bh, g.H - h0), wlen = min(g.bw, g.W - w0);
    const float* xd = fsm + s * stage_floats + pi * RC;
    const float* gd = fsm + s * stage_floats + gs_off + po * RO;
    for (int l = split; l < nd * nh; l += splits) {
      const int ld = l / nh, lh = l - ld * nh;
      const float* xp = xd + ((ld + kd) * g.hh + lh + kh) * g.hw * CIt;
      const float* gp = gd + (ld * g.bh + lh) * g.bw * COt;
      float xa[RC], xb[RC], xc[RC];
      lds(xa, xp);
      lds(xb, xp + CIt);
      int w = 0;
      for (; w + 3 <= wlen; w += 3) {
        step(xa, xb, xc, xp + (w + 2) * CIt, gp + w * COt);
        step(xb, xc, xa, xp + (w + 3) * CIt, gp + (w + 1) * COt);
        step(xc, xa, xb, xp + (w + 4) * CIt, gp + (w + 2) * COt);
      }
      if (w < wlen) step(xa, xb, xc, xp + (w + 2) * CIt, gp + w * COt);
      if (w + 1 < wlen) step(xb, xc, xa, xp + (w + 3) * CIt, gp + (w + 1) * COt);
    }
    __syncthreads();  // stage s is refilled by the next iteration
    n = n1, d0 = d1, h0 = h1, w0 = w1;
  }

  // the splits' sums, added in split order by the threads of split 0
  constexpr int NA = 3 * RC * RO;
  if (splits > 1) {
    float* red = fsm;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int j = 0; j < RO; ++j) red[((k * RC + i) * RO + j) * nthreads + tid] = acc[k][i][j];
    __syncthreads();
    if (split != 0) return;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int j = 0; j < RO; ++j) {
          const float* r = red + ((k * RC + i) * RO + j) * nthreads + tid;
          float sum = r[0];
          for (int q = 1; q < splits; ++q) sum += r[q * 9 * P];
          acc[k][i][j] = sum;
        }
  }
  static_assert(NA <= 96, "fma route: at most 96 accumulators a thread");
  const Out<T> out(partial, dw, g);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long tap = (long long)(row9 * 3 + k) * g.CI * g.CO;
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < RO; ++j) {
        const int ci = ci0 + pi * RC + i, co = co0 + po * RO + j;
        if (ci < g.CI && co < g.CO) out.put(tap + ci * g.CO + co, acc[k][i][j]);
      }
  }
}

// Two values of T in one register pair, as one voxel's 1 or 2 channels are loaded: kept as
// loaded and widened to float32 where they are used, so that no load is waited on early.
template <typename T> struct PairOf;
template <> struct PairOf<float> { using type = float2; };
template <> struct PairOf<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct PairOf<__half> { using type = __half2; };
__device__ __forceinline__ float2 pair_of(float a, float b) { return make_float2(a, b); }
__device__ __forceinline__ __nv_bfloat162 pair_of(__nv_bfloat16 a, __nv_bfloat16 b) { return __halves2bfloat162(a, b); }
__device__ __forceinline__ __half2 pair_of(__half a, __half b) { return __halves2half2(a, b); }
__device__ __forceinline__ float first(float2 v) { return v.x; }
__device__ __forceinline__ float second(float2 v) { return v.y; }
__device__ __forceinline__ float first(__nv_bfloat162 v) { return __low2float(v); }
__device__ __forceinline__ float second(__nv_bfloat162 v) { return __high2float(v); }
__device__ __forceinline__ float first(__half2 v) { return __low2float(v); }
__device__ __forceinline__ float second(__half2 v) { return __high2float(v); }

// The C channels (1 or 2) at p where ok, else zeros; pair: 2 channels in one load.
template <typename T, int C>
__device__ __forceinline__ typename PairOf<T>::type ld_raw(const T* p, bool ok, bool pair) {
  const T zero = from_float<T>(0.0f);
  if (!ok) return pair_of(zero, zero);
  if (C == 2 && pair) return *reinterpret_cast<const typename PairOf<T>::type*>(p);
  return pair_of(p[0], C == 2 ? p[1] : zero);
}

template <int C, typename V>
__device__ __forceinline__ void widen(float (&v)[C], V raw) {
  v[0] = first(raw);
  if constexpr (C == 2) v[1] = second(raw);
}

// CI and CO of 1 or 2: a brick is a strip of 32 columns (w) by bh rows (h) of one plane (d);
// a block takes a chunk of bricks, warp w the bricks (w / 3), (w / 3) + kSmallSlots, ... of
// it for kd = w % 3. Its lanes take the 32 columns and walk down the rows: a lane keeps the x
// of plane d + kd - 1 at rows h - 1, h and h + 1 in registers, at its column and the two
// beside it (from its neighbour lanes by shuffles; lanes 0 and 31 load the one beyond the
// strip), so that each x value is loaded once a kd; and the 9 taps (kh, kw) x CI x CO of its
// kd. The x and g of the rows a few ahead load while a row computes. pair: x and g
// 2-channel vectors are aligned to their size.
template <typename T, int CI, int CO>
__global__ void __launch_bounds__(kSmallThreads)
conv3d_wgrad_small_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ partial,
                          T* __restrict__ dw, Geom g, int pair) {
  constexpr int NA = 9 * CI * CO;
  __shared__ float red[kSmallThreads / 32][NA];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, kd = warp % 3;
  float acc[9][CI][CO];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < CI; ++i)
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[t][i][j] = 0.0f;

  const long long b0 = (long long)blockIdx.y * g.per_chunk;
  const long long b1 = b0 + g.per_chunk < g.bricks ? b0 + g.per_chunk : g.bricks;
  for (long long b = b0 + warp / 3; b < b1; b += kSmallSlots) {
    long long n;
    int d0, h0, w0;
    brick_origin(g, b, n, d0, h0, w0);
    const int plane = d0 + kd - 1, col = w0 + lane, ecol = lane == 0 ? col - 1 : col + 1;
    if ((unsigned)plane >= (unsigned)g.D) continue;  // the same for the whole warp
    const bool incol = col < g.W, edge = (lane == 0 || lane == 31) && (unsigned)ecol < (unsigned)g.W;
    const T* xp = x + (n * g.D + plane) * g.H * (long long)g.W * CI + col * CI;
    const T* gp = gy + (n * g.D + d0) * g.H * (long long)g.W * CO + col * CO;
    const int eo = (ecol - col) * CI;  // the column beyond the strip, from this lane's
    const unsigned xrow = (unsigned)g.W * CI, grow = (unsigned)g.W * CO;
    using V = typename PairOf<T>::type;
    // row h of the plane at this lane's column (c) and, on lanes 0 and 31, beyond the strip
    // (e); g at row h
    auto load_row = [&](int h, V& c, V& e) {
      const bool okh = (unsigned)h < (unsigned)g.H;
      c = ld_raw<T, CI>(xp + h * xrow, okh && incol, pair);
      e = ld_raw<T, CI>(xp + h * xrow + eo, okh && edge, pair);
    };
    auto load_g = [&](int h) { return ld_raw<T, CO>(gp + h * grow, h < g.H && incol, pair); };
    // a row's x at the columns w - 1, w and w + 1
    auto spread = [&](V craw, V eraw, float (&r)[3][CI]) {
      float c[CI], e[CI];
      widen(c, craw);
      widen(e, eraw);
#pragma unroll
      for (int i = 0; i < CI; ++i) {
        const float left = __shfl_up_sync(0xffffffffu, c[i], 1), right = __shfl_down_sync(0xffffffffu, c[i], 1);
        r[0][i] = lane == 0 ? e[i] : left;
        r[1][i] = c[i];
        r[2][i] = lane == 31 ? e[i] : right;
      }
    };
    // a ring of the rows ahead: entry q holds x row h + 1 and g row h for the rows h of the
    // brick that are q modulo A from its first, loaded A rows early (half as many in float32,
    // whose pairs take two registers: at four, ptxas spilled)
    constexpr int A = std::is_same<T, float>::value ? kSmallAhead / 2 : kSmallAhead;
    float r0[3][CI], r1[3][CI], r2[3][CI];
    V c0, e0, c1, e1, pc[A], pe[A], pg[A];
    load_row(h0 - 1, c0, e0);  // every load of the brick's start in flight at once
    load_row(h0, c1, e1);
#pragma unroll
    for (int q = 0; q < A; ++q) {
      load_row(h0 + 1 + q, pc[q], pe[q]);
      pg[q] = load_g(h0 + q);
    }
    spread(c0, e0, r0);
    spread(c1, e1, r1);
    const int hend = h0 + g.bh < g.H ? h0 + g.bh : g.H;
    for (int h = h0; h < hend; h += A) {
#pragma unroll
      for (int q = 0; q < A; ++q) {
        if (h + q >= hend) break;  // the same for the whole warp
        float gv[CO];
        widen(gv, pg[q]);
        spread(pc[q], pe[q], r2);
        load_row(h + q + 1 + A, pc[q], pe[q]);
        pg[q] = load_g(h + q + A);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int i = 0; i < CI; ++i)
#pragma unroll
            for (int j = 0; j < CO; ++j) {
              acc[kw][i][j] = fmaf(r0[kw][i], gv[j], acc[kw][i][j]);
              acc[3 + kw][i][j] = fmaf(r1[kw][i], gv[j], acc[3 + kw][i][j]);
              acc[6 + kw][i][j] = fmaf(r2[kw][i], gv[j], acc[6 + kw][i][j]);
            }
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int i = 0; i < CI; ++i) r0[kw][i] = r1[kw][i], r1[kw][i] = r2[kw][i];
      }
    }
  }

  // the warp's sums by a fixed shuffle tree, then the warps of each kd in order
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < CI; ++i)
#pragma unroll
      for (int j = 0; j < CO; ++j) {
        float s = acc[t][i][j];
#pragma unroll
        for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) red[warp][(t * CI + i) * CO + j] = s;
      }
  __syncthreads();
  for (int e = threadIdx.x; e < 27 * CI * CO; e += blockDim.x) {
    const int tap = e / (CI * CO), rest = e - tap * CI * CO;
    float s = 0.0f;
    for (int q = 0; q < kSmallSlots; ++q) s += red[q * 3 + tap / 9][(tap % 9) * CI * CO + rest];
    if (gridDim.y == 1)
      dw[e] = from_float<T>(s);
    else
      partial[(long long)blockIdx.y * 27 * CI * CO + e] = s;
  }
}

// dw = the chunks' partials added in a fixed order, rounded once to T. A block of 256
// threads takes 256 / G consecutive elements: thread (e, q) adds chunks q, q + G, ... of its
// element e in turn, then the G sums of each element are added in q order.
template <typename T>
__global__ void __launch_bounds__(256)
conv3d_wgrad_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw, long long n, int chunks, int G) {
  __shared__ float part[256];
  const int E = 256 / G, e0 = threadIdx.x % E, q = threadIdx.x / E;
  const long long e = (long long)blockIdx.x * E + e0;
  float sum = 0.0f;
  if (e < n)
    for (int c = q; c < chunks; c += G) sum += partial[(long long)c * n + e];
  part[threadIdx.x] = sum;
  __syncthreads();
  if (q != 0 || e >= n) return;
  float total = part[e0];
  for (int k = 1; k < G; ++k) total += part[k * E + e0];
  dw[e] = from_float<T>(total);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long round4(long long a) { return (a + 3) / 4 * 4; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

void finish_geom(Geom& g, long long N) {
  g.nbd = (int)cdiv(g.D, g.bd), g.nbh = (int)cdiv(g.H, g.bh), g.nbw = (int)cdiv(g.W, g.bw);
  g.hh = g.bh + 2, g.hw = g.bw + 2;
  g.halo = (g.bd + 2) * g.hh * g.hw;
  g.rows = g.bd * g.bh * g.bw;
  g.bricks = N * g.nbd * g.nbh * g.nbw;
}

// mma route: the brick of up to kRows voxels whose halo fits kMaxHalo with the least work
// over the volume, counted as brick rows plus halo voxels loaded.
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
        g.bd = bd, g.bh = bh, g.bw = bw;
      }
    }
  finish_geom(g, N);
  return g;
}

// fma route: lines of bw = W split evenly into pieces of at most kFmaLine; of the (bd, bh)
// whose two float32 stages fit kFmaStageBytes and whose bricks hold at most kFmaMaxRows
// voxels, the one that stages the fewest floats over the volume, a brick's fixed cost
// counted as kFmaBrickCost floats (the first such in bd, then bh order).
Geom make_fma_geom(long long N, int D, int H, int W, int CI, int CO, int CIt, int COt) {
  Geom g{D, H, W, CI, CO};
  g.bw = (int)cdiv(W, cdiv(W, kFmaLine));
  g.bd = g.bh = 1;
  long long best = -1;
  for (int bd = 1; bd <= D && bd <= 8; ++bd)
    for (int bh = 1; bh <= H && bh <= 32; ++bh) {
      const long long rows = (long long)bd * bh * g.bw, halo = (long long)(bd + 2) * (bh + 2) * (g.bw + 2);
      if (rows > kFmaMaxRows || 4 * (round4(halo * CIt) + round4(rows * COt)) > kFmaStageBytes) continue;
      const long long cost = N * cdiv(D, bd) * cdiv(H, bh) * cdiv(W, g.bw) * (halo * CIt + rows * COt + kFmaBrickCost);
      if (best < 0 || cost < best) {
        best = cost;
        g.bd = bd, g.bh = bh;
      }
    }
  finish_geom(g, N);
  return g;
}

// Of 1..most groups a block, the one that pads `groups` the least; the largest such.
int pick_groups(long long groups, int most) {
  int best = 1;
  for (int p = 2; p <= most; ++p)
    if (cdiv(groups, p) * p <= cdiv(groups, best) * best) best = p;
  return best;
}

// One launch, worked out once for each device, dtype, alignment and shape.
struct Plan {
  cudaError_t (*run)(const Plan&, const void* x, const void* g, float* partial, void* dw, cudaStream_t);
  Geom g;
  dim3 grid;
  int route;  // 0 tensor cores, 1 FMA, 2 small
  int threads, xs_bytes, rc, ro, pci, pco, splits, gs_off, stage_floats, vec;
  size_t smem;
  int chunks, per_sm, tiles_co, sms;
};

template <typename T, int MT, int NT>
cudaError_t run_mma(const Plan& p, const void* x, const void* g, float* partial, void* dw, cudaStream_t s) {
  conv3d_wgrad_mma_kernel<T, MT, NT><<<p.grid, kMmaThreads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, static_cast<T*>(dw), p.g, p.xs_bytes);
  return cudaGetLastError();
}

template <typename T, int RC, int RO>
cudaError_t run_fma(const Plan& p, const void* x, const void* g, float* partial, void* dw, cudaStream_t s) {
  conv3d_wgrad_fma_kernel<T, RC, RO><<<p.grid, p.threads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, static_cast<T*>(dw), p.g, p.pci, p.pco,
      p.splits, p.gs_off, p.stage_floats, p.vec);
  return cudaGetLastError();
}

template <typename T, int CI, int CO>
cudaError_t run_small(const Plan& p, const void* x, const void* g, float* partial, void* dw, cudaStream_t s) {
  const bool pair = reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(g) % (2 * sizeof(T)) == 0;
  conv3d_wgrad_small_kernel<T, CI, CO><<<p.grid, kSmallThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, static_cast<T*>(dw), p.g, pair);
  return cudaGetLastError();
}

// The chunks of K (each `unit` bricks or voxels at least) with the least time, counted as
// the waves of tiles x chunks blocks over the card's `slots` times the bricks a chunk plus
// a block's fixed cost (`unit`: its first load and its partials); the fewest such. Up to 4
// times the chunks that fill the card once.
long long pick_chunks(long long bricks, long long unit, long long tiles, long long slots) {
  long long best = -1, chunks = 1;
  for (long long c = 1; c <= cdiv(bricks, unit) && c <= 4 * cdiv(slots, tiles); ++c) {
    const long long per = cdiv(bricks, c), n = cdiv(bricks, per), cost = cdiv(tiles * n, slots) * (per + unit);
    if (best < 0 || cost < best) best = cost, chunks = n;
  }
  return chunks;
}

// Opt the kernel in to the most dynamic shared memory any plan of it takes (so that every
// cached plan's launch fits, whatever plan came last), ask the card how many blocks of the
// plan an SM holds, and split K into chunks (pick_chunks).
template <typename K>
cudaError_t finish_plan(Plan& p, K* kernel, size_t most_smem, long long tiles, long long unit = 1) {
  cudaError_t err = cudaSuccess;
  if (most_smem > 0) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most_smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel, p.threads, p.smem);
  if (err != cudaSuccess) return err;
  if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
  p.sms = sms;
  p.chunks = (int)pick_chunks(p.g.bricks, unit, tiles, (long long)sms * p.per_sm);
  p.g.per_chunk = cdiv(p.g.bricks, p.chunks);
  p.grid = dim3((unsigned)tiles, (unsigned)p.chunks);
  return cudaSuccess;
}

template <typename T, int MT, int NT>
cudaError_t plan_mma(Plan& p, long long N) {
  constexpr int CIt = 16 * MT, COt = 8 * NT;
  p.g = make_geom(N, p.g.D, p.g.H, p.g.W, p.g.CI, p.g.CO);
  p.route = 0;
  p.run = run_mma<T, MT, NT>;
  p.threads = kMmaThreads;
  p.rc = 16 * MT, p.ro = 8 * NT, p.pci = p.pco = p.splits = 1;
  auto xs_bytes = [](int halo) { return (halo * (CIt + 8) * (int)sizeof(T) + 127) / 128 * 128; };
  auto stage = [&](int halo) { return (size_t)xs_bytes(halo) + (size_t)kRows * (COt + 8) * sizeof(T); };
  p.xs_bytes = xs_bytes(p.g.halo);
  p.smem = 2 * stage(p.g.halo);
  p.g.tiles_ci = (int)cdiv(p.g.CI, CIt);
  p.tiles_co = (int)cdiv(p.g.CO, COt);
  return finish_plan(p, conv3d_wgrad_mma_kernel<T, MT, NT>, 2 * stage(kMaxHalo), (long long)p.g.tiles_ci * p.tiles_co);
}

template <typename T, int RC, int RO>
cudaError_t plan_fma(Plan& p, long long N, bool aligned) {
  p.route = 1;
  p.run = run_fma<T, RC, RO>;
  p.rc = RC, p.ro = RO;
  p.pco = pick_groups(cdiv(p.g.CO, RO), kFmaMaxPco);
  p.pci = pick_groups(cdiv(p.g.CI, RC), kFmaGroups / p.pco < kFmaMaxCit / RC ? kFmaGroups / p.pco : kFmaMaxCit / RC);
  const int groups = p.pci * p.pco, CIt = RC * p.pci, COt = RO * p.pco;
  p.splits = kFmaThreads / (9 * groups) > 1 ? kFmaThreads / (9 * groups) : 1;
  p.threads = 9 * groups * p.splits;
  p.g = make_fma_geom(N, p.g.D, p.g.H, p.g.W, p.g.CI, p.g.CO, CIt, COt);
  p.gs_off = (int)round4((long long)p.g.halo * CIt);
  p.stage_floats = p.gs_off + (int)round4((long long)p.g.rows * COt);
  const size_t staged = 2 * (size_t)p.stage_floats, red = p.splits > 1 ? (size_t)p.threads * 3 * RC * RO : 0;
  p.smem = 4 * (staged > red ? staged : red);
  p.vec = std::is_same<T, float>::value && aligned ? (p.g.CI % 4 == 0) | (p.g.CO % 4 == 0) << 1 : 0;
  p.g.tiles_ci = (int)cdiv(p.g.CI, CIt);
  p.tiles_co = (int)cdiv(p.g.CO, COt);
  return finish_plan(p, conv3d_wgrad_fma_kernel<T, RC, RO>, 2 * kFmaStageBytes, (long long)p.g.tiles_ci * p.tiles_co);
}

template <typename T, int CI, int CO>
cudaError_t plan_small(Plan& p, long long N) {
  p.route = 2;
  p.run = run_small<T, CI, CO>;
  p.threads = kSmallThreads;
  p.rc = CI, p.ro = CO, p.pci = p.pco = p.splits = 1;
  p.g.bd = 1, p.g.bw = 32;
  p.g.bh = (int)cdiv(p.g.H, cdiv(p.g.H, kSmallRows));
  finish_geom(p.g, N);
  p.g.tiles_ci = p.tiles_co = 1;
  p.smem = 0;
  return finish_plan(p, conv3d_wgrad_small_kernel<T, CI, CO>, 0, 1, kSmallSlots);
}

template <typename T, int RC>
cudaError_t plan_fma_ro(Plan& p, long long N, bool aligned) {
  return p.g.CO <= 2 ? plan_fma<T, RC, 2>(p, N, aligned) : plan_fma<T, RC, 4>(p, N, aligned);
}

template <typename T>
cudaError_t plan_fma_rc(Plan& p, long long N, bool aligned) {
  if (p.g.CI <= 2 && p.g.CO <= 2) {
    if (p.g.CI == 1) return p.g.CO == 1 ? plan_small<T, 1, 1>(p, N) : plan_small<T, 1, 2>(p, N);
    return p.g.CO == 1 ? plan_small<T, 2, 1>(p, N) : plan_small<T, 2, 2>(p, N);
  }
  if (p.g.CI == 1) return plan_fma_ro<T, 1>(p, N, aligned);
  if (p.g.CI == 2) return plan_fma_ro<T, 2>(p, N, aligned);
  return plan_fma_ro<T, 4>(p, N, aligned);
}

template <typename T>
cudaError_t plan_mma_tile(Plan& p, long long N) {
  const bool m2 = p.g.CI % 32 == 0;
  if (p.g.CO % 32 == 0) return m2 ? plan_mma<T, 2, 4>(p, N) : plan_mma<T, 1, 4>(p, N);
  if (p.g.CO % 16 == 0) return m2 ? plan_mma<T, 2, 2>(p, N) : plan_mma<T, 1, 2>(p, N);
  return m2 ? plan_mma<T, 2, 1>(p, N) : plan_mma<T, 1, 1>(p, N);
}

cudaError_t make_plan(Plan& p, int dtype, bool aligned, long long N, int D, int H, int W, int CI, int CO) {
  p = Plan{};
  p.g = Geom{D, H, W, CI, CO};
  const bool mma = dtype != 0 && aligned && CI % 8 == 0 && CO % 8 == 0;
  if (dtype == 0) return plan_fma_rc<float>(p, N, aligned);
  if (dtype == 1) return mma ? plan_mma_tile<__nv_bfloat16>(p, N) : plan_fma_rc<__nv_bfloat16>(p, N, aligned);
  return mma ? plan_mma_tile<__half>(p, N) : plan_fma_rc<__half>(p, N, aligned);
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

// The reduce launch's chunk groups a block: 1 (a thread an element, as many blocks as
// elements / 256) while that gives the card's `slots` blocks, else a power of two up to 32,
// each thread adding about 4 or more chunks, until it does.
int reduce_groups(int chunks, long long n, long long slots) {
  int g = 1;
  while (g < 32 && 2 * g * 4 <= chunks && cdiv(n, 256 / g) < slots) g *= 2;
  return g;
}

}  // namespace

// The plan of a launch on the current device, into out[0..18]: the route (0 tensor cores,
// 1 FMA, 2 small), the K chunks, the float32 partials the caller provides (chunks x 27 x CI
// x CO, or 0 with one chunk: the first launch then writes dw), the blocks of the first
// launch, its threads, its dynamic shared memory in bytes, the blocks an SM holds, the
// register tile (rc, ro; the mma route: its CI and CO tile), the channel groups (pci, pco)
// and line splits a block, the brick (bd, bh, bw), the CI and CO tiles, the bricks (voxels
// on the small route) and those a chunk. aligned: x and g are 16-byte aligned. Returns a
// cudaError_t.
extern "C" int monai_conv3d_3x3_wgrad_plan(long long n, int d, int h, int w, int ci, int co, int dtype, int aligned,
                                           long long* out) {
  if (!valid(n, d, h, w, ci, co, dtype)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = find_plan(p, dtype, aligned != 0, n, d, h, w, ci, co);
  if (err != cudaSuccess) return (int)cleared(err);
  const long long vals[19] = {p.route, p.chunks, p.chunks > 1 ? (long long)p.chunks * 27 * ci * co : 0,
                              (long long)p.grid.x * p.grid.y, p.threads, (long long)p.smem, p.per_sm, p.rc, p.ro,
                              p.pci, p.pco, p.splits, p.g.bd, p.g.bh, p.g.bw, p.g.tiles_ci, p.tiles_co, p.g.bricks,
                              p.g.per_chunk};
  for (int i = 0; i < 19; ++i) out[i] = vals[i];
  return 0;
}

// dw (3,3,3,CI,CO) from x (N,D,H,W,CI) and g (N,D,H,W,CO); partial holds the plan's
// float32 partial sums (monai_conv3d_3x3_wgrad_plan, out[2]; may be null where that is 0).
// dtype: 0 float32, 1 bfloat16, 2 float16. One or two launches on `stream`, no
// synchronisation. Returns a cudaError_t (0 on success).
extern "C" int monai_conv3d_3x3_wgrad(const void* x, const void* g, void* dw, float* partial, long long n, int d,
                                      int h, int w, int ci, int co, int dtype, void* stream) {
  if (!valid(n, d, h, w, ci, co, dtype)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = find_plan(p, dtype, aligned16(x) && aligned16(g), n, d, h, w, ci, co);
  if (err != cudaSuccess) return (int)cleared(err);
  if (p.chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  err = p.run(p, x, g, partial, dw, s);
  if (err != cudaSuccess || p.chunks == 1) return (int)cleared(err);
  const long long total = 27LL * ci * co;
  const int groups = reduce_groups(p.chunks, total, 2LL * p.sms);
  const unsigned blocks = (unsigned)cdiv(total, 256 / groups);
  if (dtype == 0)
    conv3d_wgrad_reduce_kernel<float><<<blocks, 256, 0, s>>>(partial, static_cast<float*>(dw), total, p.chunks,
                                                              groups);
  else if (dtype == 1)
    conv3d_wgrad_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(partial, static_cast<__nv_bfloat16*>(dw), total,
                                                                      p.chunks, groups);
  else
    conv3d_wgrad_reduce_kernel<__half><<<blocks, 256, 0, s>>>(partial, static_cast<__half*>(dw), total, p.chunks,
                                                               groups);
  return (int)cudaGetLastError();
}
