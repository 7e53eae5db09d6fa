// Fused windowed attention for Swin-style networks, forward:
//
//   out[b,h] = softmax(q[b,h] k[b,h]^T + bias[h] + mask[b % nW]) v[b,h]
//
// q, k, v and out are contiguous (B, H, N, D), bfloat16 or float32, q already scaled by
// D^-0.5; bias (H, N, N) and mask (nW, N, N) are float32, the mask optional; window b
// uses mask row b % nW. The scores, the row max, exp and the row sum are float32; the
// normalised p is rounded to the input type before p.v, which accumulates in float32;
// the output is in the input type. That is what the TPU kernel computes.
//
// Replaces monai_tpu/ops/pallas_window_attention.py::_fwd_pallas (body _attn_kernel).
// That kernel kept a block of WB windows' (N, N) f32 scores in VMEM for one head, so the
// scores never went to HBM, and let WB windows share one bias tile (_pick_wb). Here the
// scores never leave registers: a warp owns one query row at a time, each lane holds the
// scores of keys lane, lane + 32, ... (up to kMaxN / 32 of them), and the max and the sum
// are warp shuffles. K and V of the block's (window, head) sit in shared memory as f32,
// rows padded to D + 1 words so that 32 lanes reading 32 rows hit 32 banks.
// One block per (query tile of kQTile rows, head, window); the grid is flattened with the
// query tile fastest, then the head, so the blocks that read one window's mask row run
// together and share it through L2.
//
// What bounds it on the card: with D = 8 (SwinUNETR at feature size 24) both products
// have a depth of 8 and are tiny. Per (window, head) the kernel reads N^2 * 4 B of bias
// and N^2 * 4 B of mask, about 0.94 MB at N = 343, against about 3.8 MFLOP of products:
// the bias and mask reads, from L2 at best, dominate. Letting several windows of a block
// share one bias and mask tile (the TPU kernel's WB), tensor cores (mma with the depth
// padded to 16, or wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = 64;                 // query rows per block, 16 per warp
constexpr int kMaxN = 512;                 // keys per window
constexpr int kPerLane = kMaxN / 32;       // scores a lane holds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        T* __restrict__ out, int H, int N, int nW, int n_qtiles) {
  constexpr int kLd = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;            // N x kLd
  float* Vs = smem + N * kLd;  // N x kLd

  const long long blk = blockIdx.x;
  const int qt = (int)(blk % n_qtiles);
  const long long bh = blk / n_qtiles;  // b * H + h
  const int h = (int)(bh % H);
  const long long b = bh / H;

  const long long kv0 = bh * N * D;
  for (int i = threadIdx.x; i < N * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    Ks[j * kLd + d] = to_float(k[kv0 + i]);
    Vs[j * kLd + d] = to_float(v[kv0 + i]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* bias_h = bias + (long long)h * N * N;
  const float* mask_w = mask != nullptr ? mask + (b % nW) * N * N : nullptr;
  const int row_end = min(N, (qt + 1) * kQTile);

  for (int i = qt * kQTile + warp; i < row_end; i += kWarps) {  // warp-uniform
    const long long row = bh * N + i;
    float qv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = to_float(q[row * D + d]);
    const float* brow = bias_h + (long long)i * N;
    const float* mrow = mask_w != nullptr ? mask_w + (long long)i * N : nullptr;

    // scores of this lane's keys; keys past N (the padding) stay out of the max and sum
    float s[kPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < N) {
        const float* kj = Ks + j * kLd;
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc = fmaf(qv[d], kj[d], acc);
        acc += brow[j];
        if (mrow != nullptr) acc += mrow[j];
        s[t] = acc;
        mx = fmaxf(mx, acc);
      }
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const float e = lane + 32 * t < N ? expf(s[t] - mx) : 0.0f;
      s[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);

    float o[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = 0.0f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        const float p = to_float(from_float<T>(s[t] / sum));  // p in the input type
        const float* vj = Vs + j * kLd;
#pragma unroll
        for (int d = 0; d < D; ++d) o[d] = fmaf(p, vj[d], o[d]);
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float od = warp_sum(o[d]);
      if (lane == d) mine = od;
    }
    if (lane < D) out[row * D + lane] = from_float<T>(mine);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, const float* mask, void* out,
                   long long B, int H, int N, int nW, cudaStream_t stream) {
  const int n_qtiles = (N + kQTile - 1) / kQTile;
  const long long blocks = B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)N * (D + 1) * sizeof(float);
  auto kernel = window_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                       static_cast<const T*>(v), bias, mask, static_cast<T*>(out),
                                                       H, N, nW, n_qtiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* bias, const float* mask, void* out,
                     long long B, int H, int N, int D, int nW, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, bias, mask, out, B, H, N, nW, stream);
    case 16: return launch<T, 16>(q, k, v, bias, mask, out, B, H, N, nW, stream);
    case 32: return launch<T, 32>(q, k, v, bias, mask, out, B, H, N, nW, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask may be null (then nW is ignored). Returns a
// cudaError_t (0 on success); launches on `stream` and does not synchronise.
extern "C" int monai_window_attention(const void* q, const void* k, const void* v, const void* bias,
                                      const void* mask, void* out, long long B, int H, int N, int D, int nW,
                                      int dtype, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || N > kMaxN) return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (nW <= 0 || B % nW != 0)) return (int)cudaErrorInvalidValue;
  if (mask == nullptr) nW = 1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(mask);
  if (dtype == 0) return (int)launch_d<float>(q, k, v, bf, mf, out, B, H, N, D, nW, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(q, k, v, bf, mf, out, B, H, N, D, nW, s);
  return (int)cudaErrorInvalidValue;
}
