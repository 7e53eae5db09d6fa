// 3x3x3, stride-1, dilation-1, SAME (zero-padded) 3-D convolution, channels-last:
//
//   y[n,d,h,w,co] = bias[co] + sum_{kd,kh,kw,ci} x[n,d+kd-1,h+kh-1,w+kw-1,ci] * w[kd,kh,kw,ci,co]
//
// x (N,D,H,W,CI), w (3,3,3,CI,CO) and y (N,D,H,W,CO) are contiguous; bias (CO) is optional.
// float32, bfloat16 or float16 in, float32 accumulate, output in the input type.
//
// Replaces monai_tpu/ops/pallas_conv3d.py::_build_call (the Pallas kernel that
// _conv3d_pallas_fwd drives). That kernel built one im2col matrix per depth plane in
// VMEM and multiplied it by block-diagonal lane-packed weights, so that channel counts
// below 128 still filled the TPU's 128-lane matrix unit. None of that carries over: on
// Hopper the same product is an implicit GEMM with M = N*D*H*W voxels, N = CO and
// K = 27*CI, and the operands are staged in shared memory without an im2col copy.
//
// What bounds it on the card: at CO <= 32 the bytes (the input read once, the output
// written once; the UNet's and SwinUNETR's wide shallow layers), above that the
// operations (the deep layers, CI and CO up to 384). The design:
//
// - A block owns a brick of output voxels in one image (bd x bh x bw, at most BM =
//   32 x warps of them, picked on the host from the shape) and a CO tile of BN columns,
//   BN a multiple of 8 that divides CO rounded up to 8 (24 = three n8 tiles, so CO = 24
//   pads nothing). Row and halo indices come from blockIdx, once per block.
// - The brick's input plus its one-voxel halo, (bd+2)(bh+2)(bw+2) voxels, is loaded
//   once per chunk of 16 bytes of channels (8 bf16/f16, 4 f32) with cp.async, voxels
//   outside the volume zero-filled by a source size of 0, two stages deep: chunk c + 1
//   is in flight while chunk c is multiplied. An input voxel is read from L2 about
//   halo / brick (2.3-2.8) times, not once per tap.
// - Weights stream beside the halo, 27 taps x the chunk's channels x BN a stage. A block
//   owns one brick, so it reads its CO tile's weight slice once.
// - bfloat16 and float16 run on the tensor cores by mma.sync.m16n8k16 (f32 accumulate),
//   each warp 32 rows x BN. The A fragments come by ldmatrix straight from the halo
//   brick: a row's address is its voxel's place in the brick plus the tap's offset,
//   and one 16-byte row is one tap's 8 channels, so K needs no im2col copy; taps go in
//   pairs as k16 steps and the 27th as one m16n8k8. The B fragments come by
//   ldmatrix.trans from the weight rows.
// - CI not a multiple of 8 (SwinUNETR's 1 -> 24 input conv): the halo of up to 16
//   channels sits in shared memory, and each 32-deep K step builds its im2col tile from
//   it there (27 * CI entries a voxel, 27 when CI = 1) before the same MMAs. Its blocks
//   walk over bricks, and at CI = 1 build their weight tile once.
// - float32 runs on the FMA units in full precision (no TF32): each thread owns BN/8
//   voxels x 8 output channels in registers, so each shared-memory read feeds 8 or BN/8
//   FMAs.
// - The brick, the CO tile, the grid and the kernel instance of a launch are worked out
//   on the host at the first launch of each shape and kept (find_plan).
// - Layers with CO <= 4 and CI <= 8 (the UNet's 2 -> 2 output conv) skip the GEMM for a
//   direct loop, one voxel per thread (conv3d_3x3_same_direct_kernel).
//
// Left for later: TMA for the halo and the weights, wgmma, split-K at the deep layers
// (3^3 and 6^3 bricks with CI up to 384 give few blocks and a long K loop), and a
// persistent grid for the halo kernel.

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

constexpr int kMaxHalo = 640;    // halo voxels of a brick (the host picks bricks under it)
constexpr int kMaxRows = 256;    // output voxels of a brick: 32 a warp, at most 8 warps
constexpr int kTargetBlocks = 264;  // two blocks for each of the H100's 132 SMs
constexpr int kIm2colCC = 16;    // channels of the halo a step of the im2col path reads
constexpr int kIm2colLd = 40;    // the im2col tile's row stride: 32 entries + 16 bytes

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// The brick geometry of one launch, computed on the host.
struct Geom {
  int D, H, W, CI, CO;
  int bd, bh, bw;     // brick extents
  int nbd, nbh, nbw;  // bricks along each axis of one image
  int hh, hw;         // halo extents along h and w: bh + 2, bw + 2
  int halo;           // (bd + 2) * hh * hw
};

// Per block: the source voxel of each halo voxel (-1 outside the volume), the output
// voxel of each row (-1 past the volume or the brick) and each row's place in the halo.
struct BrickTables {
  long long halo_src[kMaxHalo];
  long long row_out[kMaxRows];
  int row_halo[kMaxRows];
  int tap_off[27];  // a tap's offset in the halo, in voxels
};

__device__ __forceinline__ void brick_setup(const Geom& g, int brick, int rows, BrickTables& t) {
  int b = brick;
  const int iw = b % g.nbw;
  b /= g.nbw;
  const int ih = b % g.nbh;
  b /= g.nbh;
  const int id = b % g.nbd;
  const long long n = b / g.nbd;
  const int d0 = id * g.bd, h0 = ih * g.bh, w0 = iw * g.bw;
  const int hhw = g.hh * g.hw;
  for (int v = threadIdx.x; v < g.halo; v += blockDim.x) {
    const int vd = v / hhw, vr = v - vd * hhw, vh = vr / g.hw, vw = vr - vh * g.hw;
    const int d = d0 - 1 + vd, h = h0 - 1 + vh, w = w0 - 1 + vw;
    const bool in = (unsigned)d < (unsigned)g.D && (unsigned)h < (unsigned)g.H && (unsigned)w < (unsigned)g.W;
    t.halo_src[v] = in ? ((n * g.D + d) * g.H + h) * g.W + w : -1;
  }
  const int bhw = g.bh * g.bw;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int rd = r / bhw, rr = r - rd * bhw, rh = rr / g.bw, rw = rr - rh * g.bw;
    const int d = d0 + rd, h = h0 + rh, w = w0 + rw;
    const bool in = rd < g.bd && d < g.D && h < g.H && w < g.W;
    t.row_out[r] = in ? ((n * g.D + d) * g.H + h) * g.W + w : -1;
    t.row_halo[r] = rd < g.bd ? (rd * g.hh + rh) * g.hw + rw : 0;  // a dead row reads voxel 0
  }
  if (threadIdx.x < 27) {
    const int tap = threadIdx.x;
    t.tap_off[tap] = (tap / 9) * hhw + ((tap / 3) % 3) * g.hw + tap % 3;
  }
}

// The row stride, in elements, of a BN-wide weight tile that ldmatrix reads 8 rows of
// at a time: an odd number of 16-byte units, so the 8 rows fall in 8 distinct bank groups.
template <typename T, int BN> __host__ __device__ constexpr int weight_ld() {
  return std::is_same<T, float>::value ? BN : ((BN / 8) % 2 ? BN : BN + 8);
}

// One chunk of 16 bytes of channels (KC = 16 / sizeof(T) of them, from ci0): the halo
// brick into hs[halo][KC], zero outside the volume and past CI. By cp.async where x
// allows 16-byte copies, else by plain loads.
template <typename T>
__device__ __forceinline__ void load_halo(T* hs, const T* __restrict__ x, const BrickTables& t, const Geom& g,
                                          int ci0, bool vec_x) {
  constexpr int KC = 16 / sizeof(T);
  if (vec_x) {  // CI % KC == 0 and x 16-byte aligned
    for (int v = threadIdx.x; v < g.halo; v += blockDim.x) {
      const long long src = t.halo_src[v];
      cp_async16(hs + v * KC, src >= 0 ? x + src * g.CI + ci0 : x, src >= 0 ? 16 : 0);
    }
  } else {
    const T zero = from_float<T>(0.0f);
    for (int i = threadIdx.x; i < g.halo * KC; i += blockDim.x) {
      const int v = i / KC, ci = ci0 + i % KC;
      const long long src = t.halo_src[v];
      hs[i] = src >= 0 && ci < g.CI ? x[src * g.CI + ci] : zero;
    }
  }
}

// The same chunk's weight rows into ws[27 * KC][LD] (row tap * KC + channel), BN columns
// from n0, zero past CI and CO.
template <typename T, int BN, int LD>
__device__ __forceinline__ void load_weights(T* ws, const T* __restrict__ w, const Geom& g, int ci0, int n0,
                                             bool vec_w) {
  constexpr int KC = 16 / sizeof(T);
  if (vec_w) {  // CO % KC == 0 and w 16-byte aligned
    constexpr int kVecs = BN / KC;
    for (int i = threadIdx.x; i < 27 * KC * kVecs; i += blockDim.x) {
      const int row = i / kVecs, j = (i % kVecs) * KC;
      const int tap = row / KC, ci = ci0 + row % KC;
      const bool ok = ci < g.CI && n0 + j < g.CO;
      cp_async16(ws + row * LD + j, ok ? w + ((long long)tap * g.CI + ci) * g.CO + n0 + j : w, ok ? 16 : 0);
    }
  } else {
    const T zero = from_float<T>(0.0f);
    for (int i = threadIdx.x; i < 27 * KC * BN; i += blockDim.x) {
      const int row = i / BN, j = i % BN;
      const int tap = row / KC, ci = ci0 + row % KC;
      ws[row * LD + j] = ci < g.CI && n0 + j < g.CO ? w[((long long)tap * g.CI + ci) * g.CO + n0 + j] : zero;
    }
  }
}

// The epilogue of the tensor-core kernels: bias, convert, store from the accumulators.
// A quad of lanes holds 8 consecutive channels of a row, so its stores fill 16 bytes.
template <typename T, int NT>
__device__ __forceinline__ void store_mma_tile(const float (&acc)[2][NT][4], const BrickTables& t, int row0,
                                               int n0, int CO, const T* __restrict__ bias, T* __restrict__ y) {
  const int lane = threadIdx.x % 32;
  const bool pairs = CO % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = t.row_out[row0 + i * 16 + half * 8 + lane / 4];
      if (m < 0) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + (lane % 4) * 2;
        if (n >= CO) continue;
        float v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        if (bias != nullptr) {
          v0 += to_float(bias[n]);
          if (n + 1 < CO) v1 += to_float(bias[n + 1]);
        }
        T* dst = y + m * CO + n;
        if (pairs) {  // n even and CO even: 4-byte aligned
          using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2, __nv_bfloat162>::type;
          T2 pr;
          pr.x = from_float<T>(v0);
          pr.y = from_float<T>(v1);
          *reinterpret_cast<T2*>(dst) = pr;
        } else {
          dst[0] = from_float<T>(v0);
          if (n + 1 < CO) dst[1] = from_float<T>(v1);
        }
      }
    }
}

// The k16 steps of one 16-byte channel chunk: taps (0, 1), (2, 3), ..., (24, 25) as
// m16n8k16, tap 26 as m16n8k8. hs holds the halo brick, 8 channels a voxel; ws the 27 x 8
// weight rows, LD apart. rh[i] is the halo place of this lane's row in m-tile i.
template <typename T, int NT, int LD>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][NT][4], const T* hs, const T* ws, const int (&rh)[2],
                                          const BrickTables& t) {
  const int lane = threadIdx.x % 32;
  const int hi = lane / 16;  // lanes 16-31 address the second tap of a pair / k rows 8-15
#pragma unroll
  for (int tap = 0; tap < 26; tap += 2) {
    const int off = t.tap_off[tap + hi];
    unsigned a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldsm_x4(a[i], hs + (rh[i] + off) * 8);
    unsigned b[NT][2];
    const T* brow = ws + (tap * 8 + lane % 16) * LD;
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) ldsm_x4_t(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1], brow + (j + hi) * 8);
    if (NT % 2) ldsm_x2_t(b[NT - 1][0], b[NT - 1][1], brow + (NT - 1) * 8);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_k16<T>(acc[i][j], a[i], b[j][0], b[j][1]);
  }
  const int off = t.tap_off[26];
  unsigned a[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) ldsm_x2(a[i][0], a[i][1], hs + (rh[i] + off) * 8);
  unsigned b[NT];
  const T* brow = ws + (26 * 8 + lane % 8) * LD;
  const int sel = (lane / 8) % 2;  // lanes 8-15 address the second n-tile of a pair
#pragma unroll
  for (int j = 0; j + 1 < NT; j += 2) ldsm_x2_t(b[j], b[j + 1], brow + (j + sel) * 8);
  if (NT % 2) ldsm_x1_t(b[NT - 1], brow + (NT - 1) * 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_k8<T>(acc[i][j], a[i][0], a[i][1], b[j]);
}

// bfloat16 / float16, CI % 8 == 0: the halo brick and the chunk's weight rows, two
// cp.async stages of one 8-channel chunk each, and mma.sync; one brick a block, so each
// block reads its CO tile's weight slice once, chunk by chunk. Dynamic shared memory: two
// stages of [halo][27 x 8 x LD weights], a stage's halo part halo_bytes (the halo rounded
// up to 128 bytes).
template <typename T, int BN, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
conv3d_3x3_same_mma_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                           T* __restrict__ y, Geom g, int halo_bytes, bool vec_x, bool vec_w) {
  constexpr int NT = BN / 8, LD = weight_ld<T, BN>();
  constexpr int kRows = WARPS * 32;
  constexpr int kSlabBytes = 27 * 8 * LD * (int)sizeof(T);  // weights of one chunk
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ BrickTables t;
  brick_setup(g, blockIdx.x, kRows, t);
  __syncthreads();

  const int n_chunks = g.CI / 8;
  const int n0 = blockIdx.y * BN;
  const int stage_bytes = halo_bytes + kSlabBytes;
  auto hs = [&](int s) { return reinterpret_cast<T*>(dyn + s * stage_bytes); };
  auto ws = [&](int s) { return reinterpret_cast<T*>(dyn + s * stage_bytes + halo_bytes); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 32;
  const int rh[2] = {t.row_halo[row0 + lane % 16], t.row_halo[row0 + 16 + lane % 16]};
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  load_weights<T, BN, LD>(ws(0), w, g, 0, n0, vec_w);
  load_halo<T>(hs(0), x, t, g, 0, vec_x);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      const int s = (c + 1) % 2;
      load_weights<T, BN, LD>(ws(s), w, g, (c + 1) * 8, n0, vec_w);
      load_halo<T>(hs(s), x, t, g, (c + 1) * 8, vec_x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_chunk<T, NT, LD>(acc, hs(c % 2), ws(c % 2), rh, t);
    __syncthreads();  // stage c % 2 is refilled by the next iteration
  }
  store_mma_tile<T, NT>(acc, t, row0, n0, g.CO, bias, y);
}

// bfloat16 / float16, CI not a multiple of 8: the halo of up to kIm2colCC channels in
// shared memory, and per 32-deep K step an im2col tile built from it there (each K entry's
// place in the halo from a table made once per chunk), then the same mma.sync. Four
// warps, 128 rows; the block walks over bricks blockIdx.x, + gridDim.x, ... With one K
// step in all (CI = 1: 27 entries), the weight tile is built once per block.
template <typename T, int BN>
__global__ void __launch_bounds__(128)
conv3d_3x3_same_im2col_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                              T* __restrict__ y, Geom g, int n_bricks) {
  constexpr int NT = BN / 8, LD = weight_ld<T, BN>();
  constexpr int kRows = 128;
  __shared__ BrickTables t;
  __shared__ __align__(128) T hs[kMaxHalo * kIm2colCC];
  __shared__ __align__(128) T as[kRows * kIm2colLd];
  __shared__ __align__(128) T bs[32 * LD];
  __shared__ int k_off[27 * kIm2colCC];  // K entry -> (tap offset) * cc + channel

  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 32;
  const T zero = from_float<T>(0.0f);
  const bool one_step = g.CI <= kIm2colCC && 27 * g.CI <= 32;

  for (int brick = blockIdx.x; brick < n_bricks; brick += gridDim.x) {
    __syncthreads();  // the previous brick's epilogue has read its tables
    brick_setup(g, brick, kRows, t);
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

    for (int c0 = 0; c0 < g.CI; c0 += kIm2colCC) {
      const int cc = min(kIm2colCC, g.CI - c0);
      const int K = 27 * cc;
      __syncthreads();  // the tables are set; the previous chunk's tiles are consumed
      for (int i = threadIdx.x; i < g.halo * cc; i += blockDim.x) {
        const int v = i / cc, ci = i - v * cc;
        const long long src = t.halo_src[v];
        hs[i] = src >= 0 ? x[src * g.CI + c0 + ci] : zero;
      }
      for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const int tap = k / cc;
        k_off[k] = t.tap_off[tap] * cc + (k - tap * cc);
      }
      for (int k0 = 0; k0 < K; k0 += 32) {
        __syncthreads();  // the halo and k_off are in; the previous step's tiles are consumed
        for (int i = threadIdx.x; i < kRows * 32; i += blockDim.x) {
          const int r = i / 32, k = k0 + i % 32;
          as[r * kIm2colLd + i % 32] = k < K ? hs[t.row_halo[r] * cc + k_off[k]] : zero;
        }
        if (!one_step || brick == (int)blockIdx.x) {
          for (int i = threadIdx.x; i < 32 * BN; i += blockDim.x) {
            const int kk = i / BN, j = i % BN, k = k0 + kk;
            T v = zero;
            if (k < K && n0 + j < g.CO) {
              const int tap = k / cc, ci = k - tap * cc;
              v = w[((long long)tap * g.CI + c0 + ci) * g.CO + n0 + j];
            }
            bs[kk * LD + j] = v;
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < 32; kk += 16) {
          unsigned a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldsm_x4(a[i], as + (row0 + i * 16 + lane % 16) * kIm2colLd + kk + (lane / 16) * 8);
          unsigned b[NT][2];
          const T* brow = bs + (kk + lane % 16) * LD;
#pragma unroll
          for (int j = 0; j + 1 < NT; j += 2)
            ldsm_x4_t(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1], brow + (j + lane / 16) * 8);
          if (NT % 2) ldsm_x2_t(b[NT - 1][0], b[NT - 1][1], brow + (NT - 1) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_k16<T>(acc[i][j], a[i], b[j][0], b[j][1]);
        }
      }
    }
    store_mma_tile<T, NT>(acc, t, row0, n0, g.CO, bias, y);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// float32: the same halo brick and weight rows in 4-channel chunks, two cp.async stages,
// and FMAs on register tiles: thread (vg, cg) owns rows vg, vg + VG, ... (TM = BN/8 of
// them) x channels cg*8 .. cg*8 + 7.
template <int BN>
__global__ void __launch_bounds__(128)
conv3d_3x3_same_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                           float* __restrict__ y, Geom g, int halo_bytes, bool vec_x, bool vec_w) {
  constexpr int kThreads = 128, kRows = kThreads;
  constexpr int NG = BN / 8, VG = kThreads / NG, TM = kRows / VG;
  constexpr int kWeightBytes = 27 * 4 * BN * 4;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ BrickTables t;
  brick_setup(g, blockIdx.x, kRows, t);
  __syncthreads();

  const int n0 = blockIdx.y * BN;
  const int stage_bytes = halo_bytes + kWeightBytes;
  auto hs = [&](int s) { return reinterpret_cast<float*>(dyn + s * stage_bytes); };
  auto ws = [&](int s) { return reinterpret_cast<float*>(dyn + s * stage_bytes + halo_bytes); };
  const int cg = threadIdx.x % NG, vg = threadIdx.x / NG;
  int rh[TM];
  float acc[TM][8];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    rh[j] = t.row_halo[vg + j * VG];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[j][q] = 0.0f;
  }

  const int n_chunks = (g.CI + 3) / 4;
  load_weights<float, BN, BN>(ws(0), w, g, 0, n0, vec_w);
  load_halo<float>(hs(0), x, t, g, 0, vec_x);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_weights<float, BN, BN>(ws((c + 1) % 2), w, g, (c + 1) * 4, n0, vec_w);
      load_halo<float>(hs((c + 1) % 2), x, t, g, (c + 1) * 4, vec_x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* h4 = reinterpret_cast<const float4*>(hs(c % 2));
    const float4* w4 = reinterpret_cast<const float4*>(ws(c % 2));
#pragma unroll 3
    for (int tap = 0; tap < 27; ++tap) {
      const int off = t.tap_off[tap];
      float4 a[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j) a[j] = h4[rh[j] + off];
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        const float4 b0 = w4[(tap * 4 + ci) * (BN / 4) + cg * 2];
        const float4 b1 = w4[(tap * 4 + ci) * (BN / 4) + cg * 2 + 1];
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const float av = lane_of(a[j], ci);
          acc[j][0] = fmaf(av, b0.x, acc[j][0]);
          acc[j][1] = fmaf(av, b0.y, acc[j][1]);
          acc[j][2] = fmaf(av, b0.z, acc[j][2]);
          acc[j][3] = fmaf(av, b0.w, acc[j][3]);
          acc[j][4] = fmaf(av, b1.x, acc[j][4]);
          acc[j][5] = fmaf(av, b1.y, acc[j][5]);
          acc[j][6] = fmaf(av, b1.z, acc[j][6]);
          acc[j][7] = fmaf(av, b1.w, acc[j][7]);
        }
      }
    }
    __syncthreads();
  }

  const int n = n0 + cg * 8;
  const bool vec_y = g.CO % 4 == 0;
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const long long m = t.row_out[vg + j * VG];
    if (m < 0) continue;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = acc[j][q] + (bias != nullptr && n + q < g.CO ? bias[n + q] : 0.0f);
    float* dst = y + m * g.CO + n;
    if (vec_y && n + 8 <= g.CO) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (n + q < g.CO) dst[q] = v[q];
    }
  }
}

// Narrow layers (CI <= 8, CO <= 4; the UNet's 2 -> 2 output conv at 96^3): a GEMM tile
// of BN = 16 columns would be at least 3/4 empty, and the layer is pure data movement.
// One thread computes all CO outputs of one voxel from its 27 x CI neighbours, which
// the neighbouring threads of its warp share through L1; the weights sit in shared
// memory as f32.
constexpr int kDirectMaxCI = 8, kDirectMaxCO = 4, kDirectThreads = 256;

template <typename T, int CO>
__global__ void __launch_bounds__(kDirectThreads)
conv3d_3x3_same_direct_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                              T* __restrict__ y, long long M, int D, int H, int W, int CI) {
  __shared__ float ws[27 * kDirectMaxCI * CO];
  for (int i = threadIdx.x; i < 27 * CI * CO; i += kDirectThreads) ws[i] = to_float(w[i]);
  __syncthreads();
  const long long m = (long long)blockIdx.x * kDirectThreads + threadIdx.x;
  if (m >= M) return;
  const int HW = H * W;
  const long long DHW = (long long)D * HW;
  const int rem = (int)(m - (m / DHW) * DHW);
  const int d = rem / HW, h = (rem - d * HW) / W, w0 = rem - d * HW - h * W;
  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = bias != nullptr ? to_float(bias[co]) : 0.0f;
#pragma unroll  // constant tap offsets, and the 27 loads in flight together
  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int dd = d + kd - 1, hh = h + kh - 1, ww = w0 + kw - 1;
    if ((unsigned)dd >= (unsigned)D || (unsigned)hh >= (unsigned)H || (unsigned)ww >= (unsigned)W) continue;
    const T* xp = x + (m + (long long)(kd - 1) * HW + (kh - 1) * W + (kw - 1)) * CI;
    const float* wp = ws + tap * CI * CO;
    for (int ci = 0; ci < CI; ++ci) {
      const float xv = to_float(xp[ci]);
#pragma unroll
      for (int co = 0; co < CO; ++co) acc[co] = fmaf(xv, wp[ci * CO + co], acc[co]);
    }
  }
#pragma unroll
  for (int co = 0; co < CO; ++co) y[m * CO + co] = from_float<T>(acc[co]);
}

template <typename T>
cudaError_t launch_direct(const void* x, const void* w, const void* bias, void* y, long long M, int D, int H,
                          int W, int CI, int CO, cudaStream_t stream) {
  const unsigned grid = (unsigned)((M + kDirectThreads - 1) / kDirectThreads);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  switch (CO) {
    case 1: conv3d_3x3_same_direct_kernel<T, 1><<<grid, kDirectThreads, 0, stream>>>(xt, wt, bt, yt, M, D, H, W, CI); break;
    case 2: conv3d_3x3_same_direct_kernel<T, 2><<<grid, kDirectThreads, 0, stream>>>(xt, wt, bt, yt, M, D, H, W, CI); break;
    case 3: conv3d_3x3_same_direct_kernel<T, 3><<<grid, kDirectThreads, 0, stream>>>(xt, wt, bt, yt, M, D, H, W, CI); break;
    default: conv3d_3x3_same_direct_kernel<T, 4><<<grid, kDirectThreads, 0, stream>>>(xt, wt, bt, yt, M, D, H, W, CI); break;
  }
  return cudaGetLastError();
}


bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The brick of a launch with `rows` output voxels a block: of the extents whose product
// fits the rows and whose halo fits kMaxHalo, the one with the least work over the
// volume, counted as rows computed plus halo voxels loaded, brick by brick.
Geom make_geom(long long N, int D, int H, int W, int CI, int CO, int rows, long long& bricks) {
  Geom g{D, H, W, CI, CO};
  long long best = -1;
  for (int bw = 1; bw <= W && bw <= 32; ++bw)
    for (int bh = 1; bh <= H && bh <= 32 && bw * bh <= rows; ++bh) {
      int bd = D < rows / (bw * bh) ? D : rows / (bw * bh);
      while (bd > 1 && (bd + 2) * (bh + 2) * (bw + 2) > kMaxHalo) --bd;
      const int halo = (bd + 2) * (bh + 2) * (bw + 2);
      if (halo > kMaxHalo) continue;
      const long long nb = N * cdiv(D, bd) * cdiv(H, bh) * cdiv(W, bw);
      const long long cost = nb * (rows + halo);
      if (best < 0 || cost < best || (cost == best && bw > g.bw)) {
        best = cost;
        bricks = nb;
        g.bd = bd, g.bh = bh, g.bw = bw;
      }
    }
  g.nbd = (int)cdiv(D, g.bd), g.nbh = (int)cdiv(H, g.bh), g.nbw = (int)cdiv(W, g.bw);
  g.hh = g.bh + 2, g.hw = g.bw + 2;
  g.halo = (g.bd + 2) * g.hh * g.hw;
  return g;
}

// The CO tile: of the widths (descending) that divide CO rounded up to 8, the widest,
// narrowed step by step while the grid has fewer than kTargetBlocks blocks.
int pick_bn(int co, long long bricks, const int* widths, int n_widths) {
  const int co8 = (co + 7) / 8 * 8;
  int bn = 0;
  for (int i = 0; i < n_widths; ++i) {
    if (co8 % widths[i]) continue;
    if (bn != 0 && bricks * (co8 / bn) >= kTargetBlocks) break;
    bn = widths[i];
  }
  return bn;
}

constexpr int kMmaWidths[] = {64, 48, 32, 24, 16, 8};
constexpr int kF32Widths[] = {64, 32, 16, 8};
constexpr int kMaxHaloBytes = kMaxHalo * 16;  // a halo stage at the largest brick

// One launch of a GEMM kernel, worked out once for each device, dtype and shape: the
// brick, the CO tile, the grid, and the kernel instance that runs it.
struct Plan {
  cudaError_t (*run)(const Plan&, const void* x, const void* w, const void* bias, void* y, cudaStream_t);
  Geom g;
  dim3 grid;
  int bricks, halo_bytes;
  size_t smem;
};

template <typename T, int BN, int WARPS>
cudaError_t run_mma(const Plan& p, const void* x, const void* w, const void* bias, void* y, cudaStream_t s) {
  conv3d_3x3_same_mma_kernel<T, BN, WARPS><<<p.grid, WARPS * 32, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(y), p.g,
      p.halo_bytes, aligned16(x), aligned16(w) && p.g.CO % 8 == 0);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t run_im2col(const Plan& p, const void* x, const void* w, const void* bias, void* y, cudaStream_t s) {
  conv3d_3x3_same_im2col_kernel<T, BN><<<p.grid, 128, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                              static_cast<const T*>(bias), static_cast<T*>(y), p.g,
                                                              p.bricks);
  return cudaGetLastError();
}

template <int BN>
cudaError_t run_f32(const Plan& p, const void* x, const void* w, const void* bias, void* y, cudaStream_t s) {
  conv3d_3x3_same_f32_kernel<BN><<<p.grid, 128, p.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(y), p.g, p.halo_bytes, aligned16(x) && p.g.CI % 4 == 0, aligned16(w) && p.g.CO % 4 == 0);
  return cudaGetLastError();
}

// Dynamic shared memory past 48 KB needs the kernel's opt-in. It is given at the most
// that any brick needs (a halo of kMaxHalo voxels), so that every plan's launch fits.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t most) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
}

template <typename T, int BN, int WARPS>
cudaError_t plan_mma(Plan& p) {
  constexpr size_t kSlabBytes = 27 * 8 * weight_ld<T, BN>() * sizeof(T);
  p.run = run_mma<T, BN, WARPS>;
  p.smem = 2 * ((size_t)p.halo_bytes + kSlabBytes);
  const auto kernel = conv3d_3x3_same_mma_kernel<T, BN, WARPS>;
  return allow_smem(kernel, 2 * (kMaxHaloBytes + kSlabBytes));
}

template <int BN>
cudaError_t plan_f32(Plan& p) {
  constexpr size_t kWeightBytes = 27 * 4 * BN * sizeof(float);
  p.run = run_f32<BN>;
  p.smem = 2 * ((size_t)p.halo_bytes + kWeightBytes);
  const auto kernel = conv3d_3x3_same_f32_kernel<BN>;
  return allow_smem(kernel, 2 * (kMaxHaloBytes + kWeightBytes));
}

// The im2col kernel walks over bricks: as many blocks as the card holds at once (over
// the CO tiles), at most one a brick.
template <typename T, int BN>
cudaError_t plan_im2col(Plan& p) {
  p.run = run_im2col<T, BN>;
  p.smem = 0;
  const auto kernel = conv3d_3x3_same_im2col_kernel<T, BN>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128, 0);
  const long long grid_x = cdiv((long long)sms * (per_sm > 0 ? per_sm : 1), p.grid.y);
  p.grid.x = (unsigned)(grid_x < p.bricks ? grid_x : p.bricks);
  return err;
}

template <typename T, int WARPS>
cudaError_t plan_mma_bn(Plan& p, int bn) {
  switch (bn) {
    case 64: return plan_mma<T, 64, WARPS>(p);
    case 48: return plan_mma<T, 48, WARPS>(p);
    case 32: return plan_mma<T, 32, WARPS>(p);
    case 24: return plan_mma<T, 24, WARPS>(p);
    case 16: return plan_mma<T, 16, WARPS>(p);
    default: return plan_mma<T, 8, WARPS>(p);
  }
}

template <typename T>
cudaError_t plan_im2col_bn(Plan& p, int bn) {
  switch (bn) {
    case 64: return plan_im2col<T, 64>(p);
    case 48: return plan_im2col<T, 48>(p);
    case 32: return plan_im2col<T, 32>(p);
    case 24: return plan_im2col<T, 24>(p);
    case 16: return plan_im2col<T, 16>(p);
    default: return plan_im2col<T, 8>(p);
  }
}

cudaError_t plan_f32_bn(Plan& p, int bn) {
  switch (bn) {
    case 64: return plan_f32<64>(p);
    case 32: return plan_f32<32>(p);
    case 16: return plan_f32<16>(p);
    default: return plan_f32<8>(p);
  }
}

// bfloat16 and float16 run on the tensor cores: with CI % 8 == 0 on the halo kernel, in
// 256-voxel bricks (eight warps) where the grid still has kTargetBlocks blocks, else in
// 128-voxel bricks (four); with CI % 8 != 0 on the im2col kernel. float32 runs on the FMA
// kernel. The im2col and FMA kernels take 128-voxel bricks.
cudaError_t make_plan(Plan& p, int dtype, long long N, int D, int H, int W, int CI, int CO) {
  const bool f32 = dtype == 0, halo_mma = !f32 && CI % 8 == 0;
  const int* widths = f32 ? kF32Widths : kMmaWidths;
  const int n_widths = f32 ? 4 : 6;
  long long bricks = 0;
  int rows = 128, bn = 0;
  if (halo_mma) {
    p.g = make_geom(N, D, H, W, CI, CO, 256, bricks);
    bn = pick_bn(CO, bricks, widths, n_widths);
    if (bricks * cdiv(CO, bn) >= kTargetBlocks) rows = 256;
  }
  if (rows == 128) {
    p.g = make_geom(N, D, H, W, CI, CO, 128, bricks);
    bn = pick_bn(CO, bricks, widths, n_widths);
  }
  if (bricks > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.bricks = (int)bricks;
  p.halo_bytes = (p.g.halo * 16 + 127) / 128 * 128;
  p.grid = dim3((unsigned)bricks, (unsigned)cdiv(CO, bn));
  if (f32) return plan_f32_bn(p, bn);
  const bool eight = rows == 256;
  if (dtype == 1) {
    if (!halo_mma) return plan_im2col_bn<__nv_bfloat16>(p, bn);
    return eight ? plan_mma_bn<__nv_bfloat16, 8>(p, bn) : plan_mma_bn<__nv_bfloat16, 4>(p, bn);
  }
  if (!halo_mma) return plan_im2col_bn<__half>(p, bn);
  return eight ? plan_mma_bn<__half, 8>(p, bn) : plan_mma_bn<__half, 4>(p, bn);
}

// The plan of a launch on the current device, made at its first launch and kept, so a
// later launch of the same shape does no search and no attribute or occupancy query.
cudaError_t find_plan(Plan& p, int dtype, long long N, int D, int H, int W, int CI, int CO) {
  static std::mutex mu;
  static std::map<std::array<long long, 8>, Plan> plans;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<long long, 8> key{dev, dtype, N, D, H, W, CI, CO};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    p = it->second;
    return cudaSuccess;
  }
  const cudaError_t made = make_plan(p, dtype, N, D, H, W, CI, CO);
  if (made == cudaSuccess) plans.emplace(key, p);
  return made;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t (0 on success);
// launches on `stream` and does not synchronise; a refused launch leaves no error behind.
extern "C" int monai_conv3d_3x3_same(const void* x, const void* w, const void* bias, void* y, long long n,
                                     int d, int h, int w_, int ci, int co, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || h <= 0 || w_ <= 0 || ci <= 0 || co <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const long long M = n * d * h * w_;
  if ((M + kDirectThreads - 1) / kDirectThreads > 0x7fffffffLL || (long long)h * w_ > 0x7fffffffLL / 27 ||
      (long long)d * h * w_ > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (ci <= kDirectMaxCI && co <= kDirectMaxCO) {
    if (dtype == 0) return (int)launch_direct<float>(x, w, bias, y, M, d, h, w_, ci, co, s);
    if (dtype == 1) return (int)launch_direct<__nv_bfloat16>(x, w, bias, y, M, d, h, w_, ci, co, s);
    return (int)launch_direct<__half>(x, w, bias, y, M, d, h, w_, ci, co, s);
  }
  Plan p;
  const cudaError_t err = find_plan(p, dtype, n, d, h, w_, ci, co);
  if (err != cudaSuccess) return (int)cleared(err);
  return (int)cleared(p.run(p, x, w, bias, y, s));
}
