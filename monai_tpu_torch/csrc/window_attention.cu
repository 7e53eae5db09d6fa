// Fused windowed attention for Swin-style networks, forward:
//
//   out[b,h] = softmax(q[b,h] k[b,h]^T + bias[h] + mask[b % nW]) v[b,h]
//
// q, k, v and out are contiguous (B, H, N, D), float32, bfloat16 or float16, q already
// scaled by D^-0.5; bias (H, N, N) and mask (nW, N, N) are float32, the mask optional;
// window b uses mask row b % nW. The scores, the row max, exp and the row sum are
// float32; the normalised p is rounded to the input type before p.v, which accumulates
// in float32; the output is in the input type. That is what the TPU kernel computes.
//
// Replaces monai_tpu/ops/pallas_window_attention.py::_fwd_pallas (body _attn_kernel).
// That kernel kept a block of WB windows' (N, N) f32 scores in VMEM for one head, so the
// scores never went to HBM, and let WB windows share one bias tile (_pick_wb). Here the
// scores never leave registers or shared memory. Two instances:
//
// - The fast one (D in {8, 16, 32}, N <= kMaxN): a warp owns one query row at a time,
//   each lane holds the scores of keys lane, lane + 32, ... (up to kMaxN / 32 of them),
//   and the max and the sum are warp shuffles. K and V of the block's (window, head) sit
//   in shared memory as f32, rows padded to D + 1 words so that 32 lanes reading 32 rows
//   hit 32 banks. One block per (query tile of kQTile rows, head, window); the grid is
//   flattened with the query tile fastest, then the head, so the blocks that read one
//   window's mask row run together and share it through L2.
// - The generic one (every other D and N): D is a loop bound, and the keys stream
//   through shared memory in chunks of 32, one key a lane. A row takes two passes over
//   the chunks: the first finds its max and its sum (per lane, merged by shuffles at
//   the end), the second recomputes the scores, forms p = exp(s - max) / sum rounded to
//   the input type, and accumulates p.v into a float32 tile in shared memory, each lane
//   owning dims lane, lane + 32, ... No rescaled (online) softmax: p is rounded where
//   the TPU kernel rounds it. This instance is for correctness, not speed.
//
// What bounds it on the card: with D = 8 (SwinUNETR at feature size 24) both products
// have a depth of 8 and are tiny. Per (window, head) the kernel reads N^2 * 4 B of bias
// and N^2 * 4 B of mask, about 0.94 MB at N = 343, against about 3.8 MFLOP of products:
// the bias and mask reads, from L2 at best, dominate. Letting several windows of a block
// share one bias and mask tile (the TPU kernel's WB), tensor cores (mma with the depth
// padded to 16, or wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half(v); }

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

// The generic instance: any D, any N. Shared memory, all float32 at a row stride of
// D + 1 words: the query tile Qs and its output tile Os (kGQTile rows each), one chunk
// of keys Ks and values Vs (kGChunk rows each), and each warp's kGChunk probabilities Ps.
constexpr int kGQTile = 32;               // query rows per block, 8 per warp
constexpr int kGChunk = 32;               // keys per chunk, one a lane
constexpr int kGRows = kGQTile / kWarps;  // query rows a warp owns

__host__ __device__ constexpr size_t generic_smem_bytes(int D) {
  return (size_t)(2 * kGQTile + 2 * kGChunk) * (D + 1) * sizeof(float) + kWarps * kGChunk * sizeof(float);
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int rows, int D) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    dst[j * (D + 1) + d] = to_float(src[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_generic_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                const float* __restrict__ bias, const float* __restrict__ mask,
                                T* __restrict__ out, int H, int N, int D, int nW, int n_qtiles) {
  const int ld = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kGQTile * ld;
  float* Ks = Os + kGQTile * ld;
  float* Vs = Ks + kGChunk * ld;
  float* Ps = Vs + kGChunk * ld;

  const long long blk = blockIdx.x;
  const int qt = (int)(blk % n_qtiles);
  const long long bh = blk / n_qtiles;  // b * H + h
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kGQTile;
  const int q_rows = min(kGQTile, N - q0);
  const long long base = bh * N * D;  // (b, h)'s rows of q, k, v and out
  const float* bias_h = bias + (long long)h * N * N;
  const float* mask_w = mask != nullptr ? mask + (b % nW) * N * N : nullptr;

  load_rows(Qs, q + base + (long long)q0 * D, q_rows, D);
  for (int i = threadIdx.x; i < kGQTile * ld; i += kThreads) Os[i] = 0.0f;

  // the score of this lane's key j (chunk row jj) for the warp's query row r (tile row);
  // -inf for a key past N or a row past the tile
  auto score = [&](int r, int j, int jj) -> float {
    const int i = q0 + r;
    if (r >= q_rows || j >= N) return -INFINITY;
    const float* qi = Qs + r * ld;
    const float* kj = Ks + jj * ld;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(qi[d], kj[d], acc);
    acc += bias_h[(long long)i * N + j];
    if (mask_w != nullptr) acc += mask_w[(long long)i * N + j];
    return acc;
  };

  // pass 1: each lane's max and sum over its keys, for each of the warp's rows
  float m[kGRows], l[kGRows];
#pragma unroll
  for (int t = 0; t < kGRows; ++t) {
    m[t] = -INFINITY;
    l[t] = 0.0f;
  }
  for (int c0 = 0; c0 < N; c0 += kGChunk) {
    const int rows = min(kGChunk, N - c0);
    __syncthreads();  // the previous chunk is consumed (and, first time, Qs is loaded)
    load_rows(Ks, k + base + (long long)c0 * D, rows, D);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kGRows; ++t) {
      const float sc = score(warp + kWarps * t, c0 + lane, lane);
      if (sc > m[t]) {
        l[t] = l[t] * expf(m[t] - sc) + 1.0f;  // expf(-inf) = 0 for the first key
        m[t] = sc;
      } else if (sc != -INFINITY) {
        l[t] += expf(sc - m[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kGRows; ++t) {  // merge the lanes: the row's max and sum
    const float mx = warp_max(m[t]);
    l[t] = warp_sum(m[t] == -INFINITY ? 0.0f : l[t] * expf(m[t] - mx));
    m[t] = mx;
  }

  // pass 2: p = exp(s - max) / sum in the input type, and p.v into Os
  float* ps = Ps + warp * kGChunk;
  for (int c0 = 0; c0 < N; c0 += kGChunk) {
    const int rows = min(kGChunk, N - c0);
    __syncthreads();
    load_rows(Ks, k + base + (long long)c0 * D, rows, D);
    load_rows(Vs, v + base + (long long)c0 * D, rows, D);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kGRows; ++t) {
      const int r = warp + kWarps * t;
      if (r < q_rows) {  // warp-uniform
        const float sc = score(r, c0 + lane, lane);
        ps[lane] = sc == -INFINITY ? 0.0f : to_float(from_float<T>(expf(sc - m[t]) / l[t]));
        __syncwarp();
        for (int d = lane; d < D; d += 32) {
          float acc = Os[r * ld + d];
          for (int jj = 0; jj < rows; ++jj) acc = fmaf(ps[jj], Vs[jj * ld + d], acc);
          Os[r * ld + d] = acc;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q_rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    out[base + (long long)q0 * D + i] = from_float<T>(Os[r * ld + d]);
  }
}

template <typename T>
cudaError_t launch_generic(const void* q, const void* k, const void* v, const float* bias, const float* mask,
                           void* out, long long B, int H, int N, int D, int nW, cudaStream_t stream) {
  const int n_qtiles = (N + kGQTile - 1) / kGQTile;
  const long long blocks = B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = generic_smem_bytes(D);
  auto kernel = window_attention_generic_kernel<T>;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                       static_cast<const T*>(v), bias, mask, static_cast<T*>(out),
                                                       H, N, D, nW, n_qtiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* bias, const float* mask, void* out,
                     long long B, int H, int N, int D, int nW, cudaStream_t stream) {
  if (N > kMaxN) return launch_generic<T>(q, k, v, bias, mask, out, B, H, N, D, nW, stream);
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, bias, mask, out, B, H, N, nW, stream);
    case 16: return launch<T, 16>(q, k, v, bias, mask, out, B, H, N, nW, stream);
    case 32: return launch<T, 32>(q, k, v, bias, mask, out, B, H, N, nW, stream);
    default: return launch_generic<T>(q, k, v, bias, mask, out, B, H, N, D, nW, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; mask may be null (then nW is ignored). Returns a
// cudaError_t (0 on success); launches on `stream` and does not synchronise.
extern "C" int monai_window_attention(const void* q, const void* k, const void* v, const void* bias,
                                      const void* mask, void* out, long long B, int H, int N, int D, int nW,
                                      int dtype, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (nW <= 0 || B % nW != 0)) return (int)cudaErrorInvalidValue;
  if (mask == nullptr) nW = 1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(mask);
  if (dtype == 0) return (int)launch_d<float>(q, k, v, bf, mf, out, B, H, N, D, nW, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(q, k, v, bf, mf, out, B, H, N, D, nW, s);
  if (dtype == 2) return (int)launch_d<__half>(q, k, v, bf, mf, out, B, H, N, D, nW, s);
  return (int)cudaErrorInvalidValue;
}
