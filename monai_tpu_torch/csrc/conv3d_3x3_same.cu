// 3x3x3, stride-1, dilation-1, SAME (zero-padded) 3-D convolution, channels-last:
//
//   y[n,d,h,w,co] = bias[co] + sum_{kd,kh,kw,ci} x[n,d+kd-1,h+kh-1,w+kw-1,ci] * w[kd,kh,kw,ci,co]
//
// x (N,D,H,W,CI), w (3,3,3,CI,CO) and y (N,D,H,W,CO) are contiguous; bias (CO) is optional.
// bfloat16 or float32 in, float32 accumulate, output in the input type.
//
// Replaces monai_tpu/ops/pallas_conv3d.py::_build_call (the Pallas kernel that
// _conv3d_pallas_fwd drives). That kernel built one im2col matrix per depth plane in
// VMEM and multiplied it by block-diagonal lane-packed weights, so that channel counts
// below 128 still filled the TPU's 128-lane matrix unit. None of that carries over: on
// Hopper the same product is an implicit GEMM with M = N*D*H*W voxels, N = CO and
// K = 27*CI, and the im2col rows are gathered straight into shared memory.
//
// What bounds it on the card: at the UNet's shapes the GEMM is small in N (CO = 2..256)
// and the input is re-read up to 27 times, once per tap. At CO <= 32 the kernel reads
// far more bytes than it multiplies (memory and latency bound); at CO >= 64 it is bound
// by the tensor cores' throughput for mma.sync-class instructions. The design keeps each
// 64-voxel x BN-channel output tile's operands in shared memory, so the 27-fold reuse of
// an input voxel hits L1/L2 rather than device memory, picks BN in {16, 32, 64} from CO
// so that narrow layers do not waste most of the tile, and loads 16 bytes per thread
// where CI and CO allow it. bfloat16 runs on the tensor cores through WMMA
// (16x16x16, f32 accumulate); float32 runs on the FMA units in full precision.
// Layers with CO <= 4 and CI <= 8 (the 2 -> 2 output conv) skip the GEMM for a direct
// loop, one voxel per thread (see conv3d_3x3_same_direct_kernel).
// wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBM = 64;        // output voxels per block tile
constexpr int kBK = 32;        // reduction depth per step (taps x input channels)

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<16> { using type = uint4; };

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int BN>
struct Tile {
  static constexpr bool kTensorCore = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kPad = 16 / sizeof(T);  // one 16-byte vector of padding per row
  static constexpr int kLdA = kBK + kPad;      // As[kBM][kLdA]
  static constexpr int kLdB = BN + kPad;       // Bs[kBK][kLdB]
  static constexpr int kLdC = BN + 4;          // Cs[kBM][kLdC], float, tensor-core path only
  static constexpr int kAbBytes = (kBM * kLdA + kBK * kLdB) * (int)sizeof(T);
  static constexpr int kCBytes = kTensorCore ? kBM * kLdC * (int)sizeof(float) : 0;
  static constexpr int kBytes = kAbBytes > kCBytes ? kAbBytes : kCBytes;
};

template <typename T, int BN, int VEC>
__global__ void __launch_bounds__(kThreads)
conv3d_3x3_same_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                       T* __restrict__ y, long long M, int D, int H, int W, int CI, int CO) {
  using TileT = Tile<T, BN>;
  using V = typename Raw<VEC * sizeof(T)>::type;
  constexpr int kLdA = TileT::kLdA;
  constexpr int kLdB = TileT::kLdB;

  __shared__ __align__(128) unsigned char smem[TileT::kBytes];
  __shared__ long long row_base[kBM];  // element offset of the row's voxel in x
  __shared__ int row_d[kBM], row_h[kBM], row_w[kBM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * kLdA;

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int HW = H * W;
  const long long DHW = (long long)D * HW;
  const int K = 27 * CI;

  for (int r = tid; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    if (m < M) {
      const long long img = m / DHW;
      const int rem = (int)(m - img * DHW);
      const int d = rem / HW;
      const int rem2 = rem - d * HW;
      const int h = rem2 / W;
      row_base[r] = m * CI;
      row_d[r] = d;
      row_h[r] = h;
      row_w[r] = rem2 - h * W;
    } else {  // past the end: every tap falls outside the volume and reads zero
      row_base[r] = 0;
      row_d[r] = -4;
      row_h[r] = 0;
      row_w[r] = 0;
    }
  }

  // per-thread accumulators
  constexpr int kWarpsN = BN >= 64 ? 2 : 1;
  constexpr int kWarpsM = 4 / kWarpsN;
  constexpr int kWM = kBM / kWarpsM, kWN = BN / kWarpsN;
  constexpr int kFM = kWM / 16, kFN = kWN / 16;
  constexpr int kTN = 4, kCG = BN / kTN, kRG = kThreads / kCG, kTM = kBM / kRG;
  using namespace nvcuda;
  using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  constexpr int kFragM = TileT::kTensorCore ? kFM : 1;
  constexpr int kFragN = TileT::kTensorCore ? kFN : 1;
  constexpr int kSimtM = TileT::kTensorCore ? 1 : kTM;
  constexpr int kSimtN = TileT::kTensorCore ? 1 : kTN;
  AccFrag frag_acc[kFragM][kFragN];
  float acc[kSimtM][kSimtN];
  const int warp = tid / 32;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int cg = tid % kCG, rg = tid / kCG;
  if constexpr (TileT::kTensorCore) {
#pragma unroll
    for (int i = 0; i < kFragM; ++i)
#pragma unroll
      for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(frag_acc[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < kSimtM; ++i)
#pragma unroll
      for (int j = 0; j < kSimtN; ++j) acc[i][j] = 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: the im2col rows of kBM voxels, kBK reduction entries each
    for (int i = tid; i < kBM * (kBK / VEC); i += kThreads) {
      const int r = i / (kBK / VEC);
      const int kk = (i % (kBK / VEC)) * VEC;
      const int k = k0 + kk;
      V v{};
      if (k < K) {  // with VEC > 1, CI % VEC == 0, so a vector never straddles a tap or K
        const int tap = k / CI;
        const int ci = k - tap * CI;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const int dd = row_d[r] + kd - 1, hh = row_h[r] + kh - 1, ww = row_w[r] + kw - 1;
        if ((unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)W) {
          const long long off =
              row_base[r] + ((long long)(kd - 1) * HW + (kh - 1) * W + (kw - 1)) * CI + ci;
          v = *reinterpret_cast<const V*>(x + off);
        }
      }
      *reinterpret_cast<V*>(As + r * kLdA + kk) = v;
    }
    // B tile: kBK rows of the (27*CI, CO) weight matrix, BN columns
    for (int i = tid; i < kBK * (BN / VEC); i += kThreads) {
      const int kk = i / (BN / VEC);
      const int nn = (i % (BN / VEC)) * VEC;
      const int k = k0 + kk;
      V v{};
      if (k < K && n0 + nn < CO) {  // with VEC > 1, CO % VEC == 0
        v = *reinterpret_cast<const V*>(w + (long long)k * CO + n0 + nn);
      }
      *reinterpret_cast<V*>(Bs + kk * kLdB + nn) = v;
    }
    __syncthreads();

    if constexpr (TileT::kTensorCore) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFragM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kFragN];
#pragma unroll
        for (int i = 0; i < kFragM; ++i)
          wmma::load_matrix_sync(a[i], As + (warp_m * kWM + i * 16) * kLdA + kk, kLdA);
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * kLdB + warp_n * kWN + j * 16, kLdB);
#pragma unroll
        for (int i = 0; i < kFragM; ++i)
#pragma unroll
          for (int j = 0; j < kFragN; ++j) wmma::mma_sync(frag_acc[i][j], a[i], b[j], frag_acc[i][j]);
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kSimtM], bv[kSimtN];
#pragma unroll
        for (int i = 0; i < kSimtM; ++i) av[i] = to_float(As[(rg + i * kRG) * kLdA + kk]);
#pragma unroll
        for (int j = 0; j < kSimtN; ++j) bv[j] = to_float(Bs[kk * kLdB + cg * kTN + j]);
#pragma unroll
        for (int i = 0; i < kSimtM; ++i)
#pragma unroll
          for (int j = 0; j < kSimtN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: add the bias, convert, store the in-range part of the tile
  if constexpr (TileT::kTensorCore) {
    constexpr int kLdC = TileT::kLdC;
    float* Cs = reinterpret_cast<float*>(smem);  // the A/B tiles are dead after the last sync
#pragma unroll
    for (int i = 0; i < kFragM; ++i)
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::store_matrix_sync(Cs + (warp_m * kWM + i * 16) * kLdC + warp_n * kWN + j * 16,
                                frag_acc[i][j], kLdC, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kBM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const long long m = m0 + r;
      const int n = n0 + c;
      if (m < M && n < CO) {
        float v = Cs[r * kLdC + c];
        if (bias != nullptr) v += to_float(bias[n]);
        y[m * CO + n] = from_float<T>(v);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSimtM; ++i) {
      const long long m = m0 + rg + i * kRG;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kSimtN; ++j) {
        const int n = n0 + cg * kTN + j;
        if (n < CO) {
          float v = acc[i][j];
          if (bias != nullptr) v += to_float(bias[n]);
          y[m * CO + n] = from_float<T>(v);
        }
      }
    }
  }
}

template <typename T, int BN, int VEC>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, long long M, int D, int H,
                   int W, int CI, int CO, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((CO + BN - 1) / BN));
  conv3d_3x3_same_kernel<T, BN, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(y),
      M, D, H, W, CI, CO);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bn(const void* x, const void* w, const void* bias, void* y, long long M, int D, int H,
                      int W, int CI, int CO, cudaStream_t stream) {
  if (CO <= 16) return launch<T, 16, VEC>(x, w, bias, y, M, D, H, W, CI, CO, stream);
  if (CO <= 32) return launch<T, 32, VEC>(x, w, bias, y, M, D, H, W, CI, CO, stream);
  return launch<T, 64, VEC>(x, w, bias, y, M, D, H, W, CI, CO, stream);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int monai_conv3d_3x3_same(const void* x, const void* w, const void* bias, void* y, long long n,
                                     int d, int h, int w_, int ci, int co, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || h <= 0 || w_ <= 0 || ci <= 0 || co <= 0) return (int)cudaErrorInvalidValue;
  const long long M = n * d * h * w_;
  if ((M + kBM - 1) / kBM > 0x7fffffffLL || (long long)h * w_ > 0x7fffffffLL / 27 ||
      (long long)d * h * w_ > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (ci <= kDirectMaxCI && co <= kDirectMaxCO && (dtype == 0 || dtype == 1))
    return (int)(dtype == 1 ? launch_direct<__nv_bfloat16>(x, w, bias, y, M, d, h, w_, ci, co, s)
                            : launch_direct<float>(x, w, bias, y, M, d, h, w_, ci, co, s));
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  if (dtype == 1) {
    if (aligned && ci % 8 == 0 && co % 8 == 0)
      return (int)launch_bn<__nv_bfloat16, 8>(x, w, bias, y, M, d, h, w_, ci, co, s);
    return (int)launch_bn<__nv_bfloat16, 1>(x, w, bias, y, M, d, h, w_, ci, co, s);
  }
  if (dtype == 0) {
    if (aligned && ci % 4 == 0 && co % 4 == 0)
      return (int)launch_bn<float, 4>(x, w, bias, y, M, d, h, w_, ci, co, s);
    return (int)launch_bn<float, 1>(x, w, bias, y, M, d, h, w_, ci, co, s);
  }
  return (int)cudaErrorInvalidValue;
}
