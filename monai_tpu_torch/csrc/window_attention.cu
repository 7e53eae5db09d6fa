// Fused windowed attention for Swin-style networks, forward:
//
//   out[b,h] = softmax(q[b,h] k[b,h]^T + bias[h] + mask[b % nW]) v[b,h]
//
// q, k, v and out are contiguous (B, H, N, D), float32, bfloat16 or float16, q already
// scaled by D^-0.5; bias (H, N, N) and mask (nW, N, N) are float32, the mask optional;
// window b uses mask row b % nW. The scores, the row max, exp and the row sum are
// float32; the normalised p is rounded to the input type before p.v, which accumulates
// in float32; the output is in the input type. That is what the TPU kernel computes.
// Under autograd every instance also writes each score row's float32 log-sum-exp,
// max + log(sum), into lse (B, H, N), which the backward (window_attention_bwd.cu) reads;
// in inference lse is null and nothing more is written.
//
// Replaces monai_tpu/ops/pallas_window_attention.py::_fwd_pallas (body _attn_kernel).
// That kernel kept a block of WB windows' (N, N) f32 scores in VMEM for one head, so the
// scores never went to HBM, and let the WB windows of a grid step share one bias tile and
// one mask tile (_pick_wb). Here the scores never leave registers.
//
// What bounds it on the card in bfloat16 and float16: the exps. SwinUNETR at feature
// size 24 (D = 8, N = 343) computes 2.1e9 scores a 6-window forward, one exp each; the
// special-function units give 16 a clock an SM, 4.2e12/s on an H100, so 0.51 ms a
// forward. The bytes (q, k, v, out, bias and mask read or written once) take 0.19 ms,
// the products 0.07 ms. Per score a kernel also adds the bias and mask, takes the max,
// subtracts, sums, scales and rounds: about as many FP32 issue slots as the exp unit's.
//
// Four instances, routed by launch_d (pick_instance):
//
// - The tensor-core one (bfloat16 and float16, D in {8, 16, 32}, N <= 512, q, k, v and
//   out 16-byte aligned; every SwinUNETR site at feature sizes 24 and 48). A block owns a
//   tile of 64 query rows (48 at D = 8 and N in (224, 352], below) of one head h and one
//   mask row w, and walks over the windows b = w, w + nW, ... that use that row (without
//   a mask, over a run of consecutive windows, all of which share bias[h]). It stages the
//   addend tile bias[h] + mask[w] (tile rows x N keys, float32), every load of a row in
//   flight at once, in shared memory once and reads it for each of its windows, so the
//   bias and mask are read from L2 once a block, not once a window and head: at the
//   first stage's masked site that is ~1 GB through L2 where a window a block took 5.8 GB.
//   K and V of each window arrive in their own type by cp.async, 16 bytes a copy,
//   double-buffered so that the next window's rows land while this one computes; key
//   rows past N are zero-filled (a source size of 0) and never read from memory.
//   S = Q K^T runs on mma.sync (m16n8k8 at D = 8, m16n8k16 above) and accumulates onto
//   the addend, read from the tile as float2 pairs in the accumulator's layout; the K
//   fragments come by ldmatrix straight from the K rows, the Q fragments from global
//   memory once a window. The rows go in groups of 16, each split over two warps by key
//   halves, so a warp holds at most 16 rows x 176 keys of scores (88 registers a thread
//   at N = 343), and the pair exchanges its row max, row sum and partial output through
//   shared memory behind a 64-thread named barrier. The max is taken over quads by
//   shuffles, then over the pair; e = 2^(s log2 e - max log2 e) on the exp unit; p = e
//   (1/sum) rounded to the input type, two score tiles of adjacent keys packed as one
//   m16n8k16 A fragment; P V on mma.sync with V's fragments by ldmatrix.trans,
//   accumulated in float32. Keys past N carry -inf in the addend tile (or in place of it
//   past the tile), so they add nothing. No rescaled (online) softmax: p is rounded where
//   the TPU kernel rounds it. Summing bias + mask before the product, and multiplying by
//   1/sum instead of dividing, move the float32 scores and p by about one ulp, far inside
//   the bfloat16 and float16 tolerances. At the Swin windows (N = 343 and 216) both
//   halves hold the same number of key chunks, and an instance without bounds on its
//   chunk loops runs them: its straight-line code overlaps the chunks' latencies. Two
//   blocks an SM at D = 8 cap a thread at 128 registers with four row groups (eight
//   warps); at N = 343 that instance needs ~142, so it takes three row groups (six
//   warps) and ptxas spills nothing. How many windows a block walks over is chosen on the
//   host from the shape: the fewest waves of resident blocks, counting the addend tile as
//   one window's work, with at least two blocks an SM where the shape allows. The grid
//   runs the query tiles, then the heads, of one mask row together, so the row stays in
//   L2.
// - The float32 tensor-core one ("tf32x3": float32, D in {8, 16, 32}, N <= 512, q, k, v
//   and out 16-byte aligned; every site of the float32 SwinUNETR step and of its sliding
//   window). It replaces, on those shapes, the FMA instance below, which took 15.1-17.0 ms
//   a float32 BTCV training step (batch 4 of 96^3, eight sites, 1.43e9 scores at D = 16;
//   PERF.md §6): its K and V were restaged for each 64-row tile, the addend read from L2
//   for every window and row, and every multiply-add of both products read one word of
//   shared memory, which held them to the shared memory's rate. What bounds float32 here:
//   the two N^2 D products, 4 D flops a score, 1.37 ms a step at the FMA pipe's 67
//   TFLOP/s; the exps take 0.34. On the tensor cores in 3xTF32 they are 3 x 91.5 GFLOP,
//   0.55 ms at the TF32 rate of 495 TFLOP/s (wgmma's; mma.sync reaches less), and this
//   instance is built against that floor. It keeps the block structure above (the addend
//   tile once a block, K and V of the mask row's windows double-buffered by cp.async, the
//   windows a block by split_rows, the softmax in registers with the row max exchanged by
//   the warps of a row group), in key chunks of 8: both products run on mma.sync m16n8k8
//   in TF32 three times, each float32 operand x split into big (x with its low 13 bits
//   cleared, which mma.sync ignores) and small (x - big, exact, likewise cleared), a
//   product big.big + big.small + small.big accumulated in float32 (an error of ~2^-20 of
//   the product: float32's precision, not TF32's). The split is two masks and a
//   subtraction (not cvt.rna.tf32, which runs at the conversion unit's rate, PERF.md §6);
//   Q's fragments are split once a window (the next window's Q in registers
//   meanwhile), K's and V's at each fragment load (split once at staging they would take
//   twice the shared memory, which does not fit beside a 64-row addend tile). The
//   fragment layouts and the order each contraction takes (window_attention_tf32_kernel)
//   make a lane's K row one float2 or float4 load and let S's accumulator serve as the A
//   fragment of E V as it stands; K rows of 8, 16 or 48 floats and V rows of D + 4 put a
//   warp's reads in distinct banks. The warps multiply the unnormalised exps by V and
//   the group's first warp scales the sum by 1/sum (p is float32, the input type), so a
//   window takes two barriers of the group, not three. At the 7^3 windows (D = 16) a block
//   of 64 rows and 8 warps holds 192 KB of shared memory (the 88 KB addend tile, K and V
//   twice), one block an SM; at D = 8 four warps share a row group's keys, 16 warps a
//   block. 3.18 ms a step at D = 16, 2.24 at D = 8, on an H100 SXM at 700 W (PERF.md §6,
//   which also lists what was measured and dropped: four warps a group at D = 16, which
//   spilled; Q staged by cp.async; the addend staged several rows a warp at once).
// - The FMA one (a shape of either tensor-core kind, in any type, whose q, k, v or out is
//   not 16-byte aligned): a warp owns one query row at a time, each lane holds the scores
//   of keys lane, lane + 32, ... (up to kMaxN / 32 of them), and the max and the sum are
//   warp shuffles. K and V of the block's (window, head) sit in shared memory as f32, rows
//   padded to D + 1 words. One block per (query tile of kQTile rows, head, window).
//   float32 stays on the FMA units in full precision.
// - The generic one (every other D and N): D is a loop bound, and the keys stream
//   through shared memory in chunks of 32, one key a lane. A row takes two passes over
//   the chunks: the first finds its max and its sum (per lane, merged by shuffles at
//   the end), the second recomputes the scores, forms p = exp(s - max) / sum rounded to
//   the input type, and accumulates p.v into a float32 tile in shared memory, each lane
//   owning dims lane, lane + 32, ... This instance is for correctness, not speed.
//
// Left for later: wgmma (D = 8 is below its bfloat16 depth of 16), TMA for K, V and the
// addend tile, and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <array>
#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>

#include "mma_sync.cuh"
#include "runtime_error.cuh"

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
                        T* __restrict__ out, float* __restrict__ lse, int H, int N, int nW, int n_qtiles) {
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
    if (lse != nullptr && lane == 0) lse[row] = mx + logf(sum);

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
                   float* lse, long long B, int H, int N, int nW, cudaStream_t stream) {
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
                                                       lse, H, N, nW, n_qtiles);
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
                                T* __restrict__ out, float* __restrict__ lse, int H, int N, int D, int nW,
                                int n_qtiles) {
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
    const int r = warp + kWarps * t;
    if (lse != nullptr && lane == 0 && r < q_rows) lse[bh * N + q0 + r] = mx + logf(l[t]);
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
                           void* out, float* lse, long long B, int H, int N, int D, int nW, cudaStream_t stream) {
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
                                                       lse, H, N, D, nW, n_qtiles);
  return cudaGetLastError();
}


// The tensor-core instance. A block has RG row groups of 16 query rows, two warps each
// (one a key half). Shared memory: the addend tile (16 RG rows x lda float32), then
// `stages` buffers of K and V (np rows of LDK elements each, np = N rounded up to 16),
// then the pairs' exchange: row max and row sum ([2][2 halves][16 RG] float32) and the
// second half's partial output ([RG][D / 8][4][32] float32).
constexpr float kLog2e = 1.4426950408889634f;

struct MmaGeom {
  int H, N, nW;          // nW = 1 without a mask
  int n_qtiles;          // query tiles of 16 RG rows
  int per_row;           // windows that use one mask row, B / nW
  int splits, wb;        // blocks a mask row's windows are split over, and windows a block
  int lda;               // the addend tile's row stride, in floats
  int stages;            // K and V buffers: 2 (double-buffered) or 1
};

// K and V rows in shared memory: 16 bytes at D = 8 (ldmatrix's 8 rows span all 32
// banks), else D + 8 elements, an odd number of 16-byte units, so 8 rows fall in 8
// distinct bank groups.
template <int D> __host__ __device__ constexpr int kv_ld() { return D == 8 ? 8 : D + 8; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two warps of a row group (64 threads) wait for each other; named barrier 1 + group
__device__ __forceinline__ void pair_sync(int id) { asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory"); }

template <typename T> __device__ __forceinline__ unsigned pack2(float lo, float hi);
template <> __device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
template <> __device__ __forceinline__ unsigned pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// CH: the most k16 chunks of keys a warp holds (its half of N rounded up to 16); FULL:
// both halves hold exactly CH chunks (N rounded up to 16 is 32 CH), so the chunk loops
// need no bound; RG: row groups; MINB: the blocks an SM should hold, which caps the
// registers.
template <typename T, int D, int CH, bool FULL, int RG, int MINB>
__global__ void __launch_bounds__(64 * RG, MINB)
window_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const float* __restrict__ bias, const float* __restrict__ mask, T* __restrict__ out,
                            float* __restrict__ lse, MmaGeom g) {
  constexpr int LDK = kv_ld<D>();
  constexpr int NT = D / 8;                // n8 tiles of the output
  constexpr int KQ = D == 8 ? 1 : D / 16;  // Q fragments (k8 at D = 8, else k16 steps)
  constexpr int kTile = 16 * RG, kBlockWarps = 2 * RG, kBlockThreads = 64 * RG;
  const int N = g.N, np = (N + 15) & ~15, n8 = (N + 7) & ~7;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* addend = reinterpret_cast<float*>(smem_raw);
  T* kv = reinterpret_cast<T*>(addend + kTile * g.lda);
  float* red = reinterpret_cast<float*>(kv + g.stages * 2 * np * LDK);
  float* xo = red + 4 * kTile;

  int blk = blockIdx.x;
  const int qt = blk % g.n_qtiles;
  blk /= g.n_qtiles;
  const int h = blk % g.H;
  blk /= g.H;
  const int split = blk % g.splits, w = blk / g.splits;
  const int j0 = split * g.wb, count = min(g.wb, g.per_row - j0);
  const int q0 = qt * kTile;
  auto window = [&](int j) -> long long { return ((long long)w + (long long)g.nW * (j0 + j)) * g.H + h; };

  // K and V of the block's j-th window into buffer st; rows past N zero-filled
  auto issue = [&](int j, int st) {
    constexpr int P = D / 8;  // 16-byte pieces a row
    const long long base = window(j) * N * D;
    T* ks = kv + st * 2 * np * LDK;
    T* vs = ks + np * LDK;
    for (int i = threadIdx.x; i < np * P; i += kBlockThreads) {
      const int r = i / P, c = (i % P) * 8;
      const long long src = r < N ? base + (long long)r * D + c : 0;
      cp_async16(ks + r * LDK + c, k + src, r < N ? 16 : 0);
      cp_async16(vs + r * LDK + c, v + src, r < N ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0, 0);

  // the addend tile: bias[h] + mask[w] for the tile's rows, 0 in rows past N, -inf in
  // the keys from N up to n8
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  {
    const float* brows = bias + ((long long)h * N + q0) * N;
    const float* mrows = mask != nullptr ? mask + ((long long)w * N + q0) * N : nullptr;
    for (int r = warp; r < kTile; r += kBlockWarps) {  // every load of a row in flight at once
      const bool row_in = q0 + r < N;
      const float* br = brows + (long long)r * N;
      const float* mr = mrows != nullptr ? mrows + (long long)r * N : nullptr;
      float a[kMaxN / 32];
#pragma unroll
      for (int u = 0; u < kMaxN / 32; ++u) {
        const int j = lane + 32 * u;
        a[u] = -INFINITY;
        if (j < N) a[u] = row_in ? br[j] + (mr != nullptr ? mr[j] : 0.0f) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kMaxN / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < n8) addend[r * g.lda + j] = a[u];
      }
    }
  }

  const int rg = warp % RG, half = warp / RG;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = rg * 16;
  const bool live = q0 + r0 < N;  // the row group has a row in the window (warp-uniform)
  const int nc = np / 16, nc0 = (nc + 1) / 2;
  const int c_begin = half ? nc0 : 0, my_nc = half ? nc - nc0 : nc0;
  const int row_a = q0 + r0 + g8, row_b = row_a + 8;
  const float* arow_a = addend + (r0 + g8) * g.lda + 2 * t4;
  const float* arow_b = arow_a + 8 * g.lda;
  float* rmax = red;
  float* rsum = red + 2 * kTile;
  float* xw = xo + rg * (NT * 4 * 32);

  // the warp's Q fragments of window j: k8 {a0, a1} at D = 8, else a k16 {a0..a3} a step
  auto load_q = [&](int j, unsigned (&qf)[KQ][4]) {
    const unsigned* qw = reinterpret_cast<const unsigned*>(q + window(j) * N * D);
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int col = kk * 16 + 2 * t4;
      qf[kk][0] = row_a < N ? qw[(row_a * D + col) >> 1] : 0u;
      qf[kk][1] = row_b < N ? qw[(row_b * D + col) >> 1] : 0u;
      if (D != 8) {
        qf[kk][2] = row_a < N ? qw[(row_a * D + col + 8) >> 1] : 0u;
        qf[kk][3] = row_b < N ? qw[(row_b * D + col + 8) >> 1] : 0u;
      }
    }
  };
  unsigned qf[KQ][4] = {}, qn[KQ][4] = {};
  if (live) load_q(0, qf);

  for (int j = 0; j < count; ++j) {
    const int st = g.stages == 2 ? (j & 1) : 0;
    cp_async_wait<0>();
    __syncthreads();  // window j's K and V (and, the first time, the addend tile) are in
    if (g.stages == 2 && j + 1 < count) issue(j + 1, st ^ 1);
    if (live) {  // warp-uniform, and the same for both warps of a pair
      const T* ks = kv + st * 2 * np * LDK;
      const T* vs = ks + np * LDK;

      // S = Q K^T + addend, this warp's key chunks
      float s[2 * CH][4];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (FULL || c < my_nc) {
          const int key0 = (c_begin + c) * 16;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int n0 = key0 + 8 * jj;
            if ((FULL && (c < CH - 1 || jj == 0)) || n0 < n8) {
              const float2 a = *reinterpret_cast<const float2*>(arow_a + n0);
              const float2 b = *reinterpret_cast<const float2*>(arow_b + n0);
              s[2 * c + jj][0] = a.x;
              s[2 * c + jj][1] = a.y;
              s[2 * c + jj][2] = b.x;
              s[2 * c + jj][3] = b.y;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) s[2 * c + jj][e] = -INFINITY;
            }
          }
          if constexpr (D == 8) {
            unsigned b0, b1;
            ldsm_x2(b0, b1, ks + (key0 + (lane & 15)) * LDK);
            mma_k8<T>(s[2 * c], qf[0][0], qf[0][1], b0);
            mma_k8<T>(s[2 * c + 1], qf[0][0], qf[0][1], b1);
          } else if constexpr (D == 16) {
            unsigned b[4];
            ldsm_x4(b, ks + (key0 + (lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 8);
            mma_k16<T>(s[2 * c], qf[0], b[0], b[1]);
            mma_k16<T>(s[2 * c + 1], qf[0], b[2], b[3]);
          } else {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              unsigned b[4];
              ldsm_x4(b, ks + (key0 + 8 * jj + (lane & 7)) * LDK + (lane >> 3) * 8);
              mma_k16<T>(s[2 * c + jj], qf[0], b[0], b[1]);
              mma_k16<T>(s[2 * c + jj], qf[1], b[2], b[3]);
            }
          }
        }
      }
      if (j + 1 < count) load_q(j + 1, qn);  // in flight through the softmax

      // the row max (rows g8 and g8 + 8 of the group): the quad, then the pair
      float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2 * CH; ++t) {
        if (FULL || t < 2 * my_nc) {
          ma = fmaxf(ma, fmaxf(s[t][0], s[t][1]));
          mb = fmaxf(mb, fmaxf(s[t][2], s[t][3]));
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      }
      if (t4 == 0) {
        rmax[half * kTile + r0 + g8] = ma;
        rmax[half * kTile + r0 + g8 + 8] = mb;
      }
      pair_sync(1 + rg);
      ma = fmaxf(ma, rmax[(half ^ 1) * kTile + r0 + g8]);
      mb = fmaxf(mb, rmax[(half ^ 1) * kTile + r0 + g8 + 8]);

      // e = exp(s - max) and the row sum
      const float la = ma * kLog2e, lb = mb * kLog2e;
      float sa = 0.0f, sb = 0.0f;
#pragma unroll
      for (int t = 0; t < 2 * CH; ++t) {
        if (FULL || t < 2 * my_nc) {
          s[t][0] = ex2(fmaf(s[t][0], kLog2e, -la));
          s[t][1] = ex2(fmaf(s[t][1], kLog2e, -la));
          s[t][2] = ex2(fmaf(s[t][2], kLog2e, -lb));
          s[t][3] = ex2(fmaf(s[t][3], kLog2e, -lb));
          sa += s[t][0] + s[t][1];
          sb += s[t][2] + s[t][3];
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      }
      if (t4 == 0) {
        rsum[half * kTile + r0 + g8] = sa;
        rsum[half * kTile + r0 + g8 + 8] = sb;
      }
      pair_sync(1 + rg);
      const float suma = sa + rsum[(half ^ 1) * kTile + r0 + g8];
      const float sumb = sb + rsum[(half ^ 1) * kTile + r0 + g8 + 8];
      const float ia = 1.0f / suma, ib = 1.0f / sumb;
      if (lse != nullptr && !half && t4 == 0) {
        float* lw = lse + window(j) * N;
        if (row_a < N) lw[row_a] = ma + logf(suma);
        if (row_b < N) lw[row_b] = mb + logf(sumb);
      }

      // O = P V over this warp's keys: p rounded to T, two adjacent n8 score tiles as
      // one k16 A fragment
      float o[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (FULL || c < my_nc) {
          const unsigned a[4] = {pack2<T>(s[2 * c][0] * ia, s[2 * c][1] * ia),
                                 pack2<T>(s[2 * c][2] * ib, s[2 * c][3] * ib),
                                 pack2<T>(s[2 * c + 1][0] * ia, s[2 * c + 1][1] * ia),
                                 pack2<T>(s[2 * c + 1][2] * ib, s[2 * c + 1][3] * ib)};
          const T* vrow = vs + ((c_begin + c) * 16 + (lane & 15)) * LDK;
          if constexpr (D == 8) {
            unsigned b0, b1;
            ldsm_x2_t(b0, b1, vrow);
            mma_k16<T>(o[0], a, b0, b1);
          } else {
#pragma unroll
            for (int dt = 0; dt < D / 16; ++dt) {
              unsigned b0, b1, b2, b3;
              ldsm_x4_t(b0, b1, b2, b3, vrow + dt * 16 + (lane >> 4) * 8);
              mma_k16<T>(o[2 * dt], a, b0, b1);
              mma_k16<T>(o[2 * dt + 1], a, b2, b3);
            }
          }
        }
      }

      // the second half hands its partial output to the first, which stores the sum
      if (half) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) xw[(nt * 4 + e) * 32 + lane] = o[nt][e];
      }
      pair_sync(1 + rg);
      if (!half) {
        T* ow = out + window(j) * N * D;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] += xw[(nt * 4 + e) * 32 + lane];
          const int col = nt * 8 + 2 * t4;
          if (row_a < N) *reinterpret_cast<unsigned*>(ow + row_a * D + col) = pack2<T>(o[nt][0], o[nt][1]);
          if (row_b < N) *reinterpret_cast<unsigned*>(ow + row_b * D + col) = pack2<T>(o[nt][2], o[nt][3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kk][e] = qn[kk][e];
    }
    if (g.stages == 1 && j + 1 < count) {
      __syncthreads();  // everyone is done with the one buffer
      issue(j + 1, 0);
    }
  }
}

// The float32 tensor-core instance ("tf32x3"). The block structure is the one above: a
// block of RG row groups owns a tile of 16 RG query rows of one head and walks the windows
// of one mask row, with the addend tile in shared memory and K and V double-buffered by
// cp.async; but a row group is KS warps, each holding one KS-th of the keys: 4 at D = 8 and
// N <= 352 (16 warps a block, 128 registers a thread), else 2 (at D = 16 a quarter of the
// keys and the fragments do not fit 128 registers without a spill). Both products run on
// mma.sync m16n8k8 in TF32, three times (3xTF32), so a key chunk is 8 keys. Shared memory: the addend tile (16 RG rows x lda float32), `stages`
// buffers of K (np rows of LDK floats) and V (np rows of LDV floats), np = N rounded up to 8,
// then each warp's row max and sum ([KS][16 RG] float32 each) and the partial outputs of
// the group's warps but its first ([KS - 1][RG][D / 8][4][32] float32).
//
// The contraction of Q K^T may take the head dims in any order, and that of P V the keys:
// - Q K^T: lane (g, t) supplies, for k8 step kk, the dims e(2 kk) and e(2 kk + 1) of its
//   row of Q (A's columns t and t + 4) and of its key's row of K (B's rows t and t + 4),
//   where e lists the dims 2t, 2t + 1 at D = 8, 4t..4t + 3 at D = 16, and 4t..4t + 3,
//   16 + 4t..16 + 4t + 3 at D = 32: one float2 or float4 load a row (tf32_row).
// - P V: S's accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of its
//   8 keys, and A's fragment is (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4). Taking A's
//   column t as key 2t and column t + 4 as key 2t + 1, P's A fragment is the accumulator's
//   registers 0, 2, 1, 3, and V's B fragment is the rows of keys 2t and 2t + 1 at column g.
// The warps multiply the exps e by V as they are and the first warp of a group scales the
// sum of their outputs by 1/sum: in float32 p is not rounded, and the sum is then needed
// only at the end.
template <int D> __host__ __device__ constexpr int tf32_k_ld() { return D == 32 ? 48 : D; }
template <int D> __host__ __device__ constexpr int tf32_v_ld() { return D + 4; }

// the D / 4 elements of a row that lane t supplies to Q K^T, in the order of the k8 steps
template <int D>
__device__ __forceinline__ void tf32_row(const float* x, int t, float (&r)[D / 4]) {
  if constexpr (D == 8) {
    const float2 a = *reinterpret_cast<const float2*>(x + 2 * t);
    r[0] = a.x;
    r[1] = a.y;
  } else {
#pragma unroll
    for (int u = 0; u < D / 16; ++u) {
      const float4 a = *reinterpret_cast<const float4*>(x + 16 * u + 4 * t);
      r[4 * u] = a.x;
      r[4 * u + 1] = a.y;
      r[4 * u + 2] = a.z;
      r[4 * u + 3] = a.w;
    }
  }
}

// the KS warps of a row group wait for each other; named barrier 1 + group
template <int KS>
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(32 * KS) : "memory");
}

// KS: warps a row group (one a part of the keys); CH: the most 8-key chunks a warp holds
// (its part of N rounded up to 8); FULL: every warp holds CH or CH - 1 chunks, so that only
// the last chunk needs a bound.
template <int D, int CH, bool FULL, int KS>
__global__ void __launch_bounds__(128 * KS, 1)
window_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ out,
                             float* __restrict__ lse, MmaGeom g) {
  constexpr int LDK = tf32_k_ld<D>(), LDV = tf32_v_ld<D>();
  constexpr int NT = D / 8;  // n8 tiles of the output, and k8 steps of Q K^T
  constexpr int E = D / 4;   // elements a lane supplies from a row of Q or K
  const int RG = blockDim.x / (32 * KS), kTile = 16 * RG, n_warps = KS * RG;
  const int N = g.N, np = (N + 7) & ~7;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* addend = reinterpret_cast<float*>(smem_raw);
  float* kv = addend + kTile * g.lda;
  const int stage = np * (LDK + LDV);
  float* rmax = kv + g.stages * stage;
  float* rsum = rmax + KS * kTile;
  float* xo = rsum + KS * kTile;

  int blk = blockIdx.x;
  const int qt = blk % g.n_qtiles;
  blk /= g.n_qtiles;
  const int h = blk % g.H;
  blk /= g.H;
  const int split = blk % g.splits, w = blk / g.splits;
  const int j0 = split * g.wb, count = min(g.wb, g.per_row - j0);
  const int q0 = qt * kTile;
  auto window = [&](int j) -> long long { return ((long long)w + (long long)g.nW * (j0 + j)) * g.H + h; };

  // K and V of the block's j-th window into buffer st; rows past N zero-filled
  auto issue = [&](int j, int st) {
    constexpr int P = D / 4;  // 16-byte pieces a row
    const long long base = window(j) * N * D;
    float* ks = kv + st * stage;
    float* vs = ks + np * LDK;
    for (int i = threadIdx.x; i < np * P; i += blockDim.x) {
      const int r = i / P, c = (i % P) * 4;
      const long long src = r < N ? base + (long long)r * D + c : 0;
      cp_async16(ks + r * LDK + c, k + src, r < N ? 16 : 0);
      cp_async16(vs + r * LDV + c, v + src, r < N ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0, 0);

  // the addend tile: bias[h] + mask[w] for the tile's rows, 0 in rows past N, -inf in
  // the keys from N up to np
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  {
    const float* brows = bias + ((long long)h * N + q0) * N;
    const float* mrows = mask != nullptr ? mask + ((long long)w * N + q0) * N : nullptr;
    for (int r = warp; r < kTile; r += n_warps) {  // every load of a row in flight at once
      const bool row_in = q0 + r < N;
      const float* br = brows + (long long)r * N;
      const float* mr = mrows != nullptr ? mrows + (long long)r * N : nullptr;
      float a[kMaxN / 32];
#pragma unroll
      for (int u = 0; u < kMaxN / 32; ++u) {
        const int j = lane + 32 * u;
        a[u] = -INFINITY;
        if (j < N) a[u] = row_in ? br[j] + (mr != nullptr ? mr[j] : 0.0f) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kMaxN / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < np) addend[r * g.lda + j] = a[u];
      }
    }
  }

  const int rg = warp % RG, part = warp / RG;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = rg * 16;
  const bool live = q0 + r0 < N;  // the row group has a row in the window (warp-uniform)
  // this warp's chunks of 8 keys: the first nc % KS parts take one more
  const int nc = np / 8, base_nc = nc / KS, extra = nc % KS;
  const int my_nc = base_nc + (part < extra), c_begin = part * base_nc + min(part, extra);
  const int row_a = q0 + r0 + g8, row_b = row_a + 8;
  const float* arow_a = addend + (r0 + g8) * g.lda + 2 * t4;
  const float* arow_b = arow_a + 8 * g.lda;
  auto has = [&](int c) { return FULL ? (c < CH - 1 || my_nc == CH) : c < my_nc; };

  // the warp's rows g8 and g8 + 8 of Q in window j, the elements this lane supplies
  auto load_q = [&](int j, float (&qa)[E], float (&qb)[E]) {
    const float* qw = q + window(j) * N * D;
#pragma unroll
    for (int e = 0; e < E; ++e) qa[e] = qb[e] = 0.0f;
    if (row_a < N) tf32_row<D>(qw + (long long)row_a * D, t4, qa);
    if (row_b < N) tf32_row<D>(qw + (long long)row_b * D, t4, qb);
  };
  float qa[E], qb[E];
  if (live) load_q(0, qa, qb);

  for (int j = 0; j < count; ++j) {
    const int st = g.stages == 2 ? (j & 1) : 0;
    cp_async_wait<0>();
    __syncthreads();  // window j's K and V (and, the first time, the addend tile) are in
    if (g.stages == 2 && j + 1 < count) issue(j + 1, st ^ 1);
    if (live) {  // warp-uniform, and the same for all warps of a group
      const float* ks = kv + st * stage;
      const float* vs = ks + np * LDK;
      FragA qf[NT];  // Q's A fragments, split once a window
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        split_tf32(qa[2 * kk], qf[kk].big[0], qf[kk].small[0]);
        split_tf32(qb[2 * kk], qf[kk].big[1], qf[kk].small[1]);
        split_tf32(qa[2 * kk + 1], qf[kk].big[2], qf[kk].small[2]);
        split_tf32(qb[2 * kk + 1], qf[kk].big[3], qf[kk].small[3]);
      }
      if (j + 1 < count) load_q(j + 1, qa, qb);  // in flight through the products and the softmax

      // S = Q K^T + addend, this warp's key chunks
      float s[CH][4];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (has(c)) {
          const int key0 = (c_begin + c) * 8;
          const float2 a = *reinterpret_cast<const float2*>(arow_a + key0);
          const float2 b = *reinterpret_cast<const float2*>(arow_b + key0);
          s[c][0] = a.x;
          s[c][1] = a.y;
          s[c][2] = b.x;
          s[c][3] = b.y;
          float kr[E], corr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          tf32_row<D>(ks + (key0 + g8) * LDK, t4, kr);
#pragma unroll
          for (int kk = 0; kk < NT; ++kk) {
            FragB fb;
            split_tf32(kr[2 * kk], fb.big[0], fb.small[0]);
            split_tf32(kr[2 * kk + 1], fb.big[1], fb.small[1]);
            mma3(s[c], corr, qf[kk], fb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][e] += corr[e];
        }
      }

      // the row max (rows g8 and g8 + 8 of the group): the quad, then the group's warps
      float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (has(c)) {
          ma = fmaxf(ma, fmaxf(s[c][0], s[c][1]));
          mb = fmaxf(mb, fmaxf(s[c][2], s[c][3]));
        }
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, sh));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, sh));
      }
      if (t4 == 0) {
        rmax[part * kTile + r0 + g8] = ma;
        rmax[part * kTile + r0 + g8 + 8] = mb;
      }
      group_sync<KS>(1 + rg);
#pragma unroll
      for (int x = 0; x < KS; ++x) {
        ma = fmaxf(ma, rmax[x * kTile + r0 + g8]);
        mb = fmaxf(mb, rmax[x * kTile + r0 + g8 + 8]);
      }

      // e = exp(s - max), its row sum, and O = E V over this warp's keys: A's column t is
      // key 2t, column t + 4 key 2t + 1
      const float la = ma * kLog2e, lb = mb * kLog2e;
      float sa = 0.0f, sb = 0.0f;
      float o[NT][4], oc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = oc[nt][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (has(c)) {
          const float e0 = ex2(fmaf(s[c][0], kLog2e, -la)), e1 = ex2(fmaf(s[c][1], kLog2e, -la));
          const float e2 = ex2(fmaf(s[c][2], kLog2e, -lb)), e3 = ex2(fmaf(s[c][3], kLog2e, -lb));
          sa += e0 + e1;
          sb += e2 + e3;
          FragA fa;
          split_tf32(e0, fa.big[0], fa.small[0]);
          split_tf32(e2, fa.big[1], fa.small[1]);
          split_tf32(e1, fa.big[2], fa.small[2]);
          split_tf32(e3, fa.big[3], fa.small[3]);
          const float* vrow = vs + ((c_begin + c) * 8 + 2 * t4) * LDV + g8;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            FragB fb;
            split_tf32(vrow[nt * 8], fb.big[0], fb.small[0]);
            split_tf32(vrow[LDV + nt * 8], fb.big[1], fb.small[1]);
            mma3(o[nt], oc[nt], fa, fb);
          }
        }
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, sh);
        sb += __shfl_xor_sync(0xffffffffu, sb, sh);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] += oc[nt][e];

      // the other warps hand their sums and partial outputs to the first, which adds them in
      // order, scales by 1/sum and stores
      if (part) {
        if (t4 == 0) {
          rsum[part * kTile + r0 + g8] = sa;
          rsum[part * kTile + r0 + g8 + 8] = sb;
        }
        float* xw = xo + ((part - 1) * RG + rg) * (NT * 4 * 32);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) xw[(nt * 4 + e) * 32 + lane] = o[nt][e];
      }
      group_sync<KS>(1 + rg);
      if (!part) {
#pragma unroll
        for (int x = 1; x < KS; ++x) {
          sa += rsum[x * kTile + r0 + g8];
          sb += rsum[x * kTile + r0 + g8 + 8];
          const float* xw = xo + ((x - 1) * RG + rg) * (NT * 4 * 32);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[nt][e] += xw[(nt * 4 + e) * 32 + lane];
        }
        const float ia = 1.0f / sa, ib = 1.0f / sb;
        if (lse != nullptr && t4 == 0) {
          float* lw = lse + window(j) * N;
          if (row_a < N) lw[row_a] = ma + logf(sa);
          if (row_b < N) lw[row_b] = mb + logf(sb);
        }
        float* ow = out + window(j) * N * D;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * t4;
          if (row_a < N)
            *reinterpret_cast<float2*>(ow + (long long)row_a * D + col) = make_float2(o[nt][0] * ia, o[nt][1] * ia);
          if (row_b < N)
            *reinterpret_cast<float2*>(ow + (long long)row_b * D + col) = make_float2(o[nt][2] * ib, o[nt][3] * ib);
        }
      }
    }
    if (g.stages == 1 && j + 1 < count) {
      __syncthreads();  // everyone is done with the one buffer
      issue(j + 1, 0);
    }
  }
}

// The launch of one shape on a tensor-core instance, or which instance runs it.
enum Instance { kMma = 0, kFma = 1, kGeneric = 2, kTf32 = 3 };

struct MmaPlan {
  cudaError_t (*run)(const MmaPlan&, const void*, const void*, const void*, const float*, const float*, void*,
                     float*, cudaStream_t);
  MmaGeom g;
  unsigned blocks;
  size_t smem;
  int per_sm;  // blocks an SM holds
  int rows;    // query rows a block
};

template <int D, int CH>
constexpr int mma_min_blocks() {  // two blocks an SM where the shared memory allows it
  return (D == 8 && CH <= 11) || (D == 16 && CH <= 7) || CH <= 4 ? 2 : 1;
}

// Three row groups where four, at two blocks an SM, would cap a thread at 128 registers
// and ptxas would spill (88 scores a thread and the unrolled chunk loops at N = 343).
template <int D, int CH>
constexpr int mma_row_groups() {
  return D == 8 && CH == 11 ? 3 : 4;
}

template <typename T, int D, int CH, bool FULL>
cudaError_t run_mma(const MmaPlan& p, const void* q, const void* k, const void* v, const float* bias,
                    const float* mask, void* out, float* lse, cudaStream_t stream) {
  constexpr int RG = mma_row_groups<D, CH>();
  window_attention_mma_kernel<T, D, CH, FULL, RG, mma_min_blocks<D, CH>()><<<p.blocks, 64 * RG, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), lse, p.g);
  return cudaGetLastError();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// How many windows a block walks over: the fewest waves of resident blocks, each block
// costing its windows plus one for staging its addend tile; at least `resident` blocks
// where the shape has that many (window, tile) pairs; of equal costs the fewer blocks.
void split_rows(MmaGeom& g, long long resident) {
  const long long base = (long long)g.n_qtiles * g.H * g.nW, per_row = g.per_row;
  long long best_cost = -1, best_wb = per_row;
  for (long long s = 1; s <= per_row; ++s) {
    const long long wb = cdiv(per_row, s);
    if (cdiv(per_row, wb) != s) continue;  // the same split as a smaller s
    const long long blocks = base * s;
    if (blocks < resident && base * per_row >= resident) continue;
    const long long cost = cdiv(blocks, resident) * (wb + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_wb = wb;
    }
  }
  g.wb = (int)best_wb;
  g.splits = (int)cdiv(per_row, best_wb);
}

template <typename T, int D, int CH, bool FULL>
cudaError_t plan_mma(MmaPlan& p, long long B, int H, int N, int nW) {
  constexpr int RG = mma_row_groups<D, CH>(), kTile = 16 * RG;
  const auto kernel = window_attention_mma_kernel<T, D, CH, FULL, RG, mma_min_blocks<D, CH>()>;
  p.run = run_mma<T, D, CH, FULL>;
  const int np = (N + 15) & ~15, n8 = (N + 7) & ~7;
  MmaGeom& g = p.g;
  g.H = H;
  g.N = N;
  g.nW = nW;
  g.n_qtiles = (N + kTile - 1) / kTile;
  g.per_row = (int)(B / nW);
  g.lda = n8 % 16 == 0 ? n8 + 8 : n8;  // 8 rows' float2 reads in distinct banks
  const size_t fixed = (size_t)kTile * g.lda * 4 + (4 * kTile + 16 * RG * D) * 4;  // + red, xo
  const size_t stage = 2 * (size_t)np * kv_ld<D>() * sizeof(T);
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (fixed + stage > (size_t)optin) return cudaErrorInvalidValue;
  g.stages = fixed + 2 * stage <= (size_t)optin ? 2 : 1;
  p.smem = fixed + g.stages * stage;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel, 64 * RG, p.smem);
  if (err != cudaSuccess) return err;
  if (p.per_sm < 1) return cudaErrorInvalidValue;
  split_rows(g, (long long)sms * p.per_sm);
  const long long blocks = (long long)g.n_qtiles * H * nW * g.splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.blocks = (unsigned)blocks;
  p.rows = kTile;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t plan_mma_ch(MmaPlan& p, long long B, int H, int N, int nW) {
  const int nc = (N + 15) / 16, half = (nc + 1) / 2;  // k16 chunks, and those of the first key half
  if (half <= 4) return plan_mma<T, D, 4, false>(p, B, H, N, nW);
  if (nc == 14) return plan_mma<T, D, 7, true>(p, B, H, N, nW);  // N in (208, 224]: the 6^3 windows
  if (half <= 7) return plan_mma<T, D, 7, false>(p, B, H, N, nW);
  if (nc == 22) return plan_mma<T, D, 11, true>(p, B, H, N, nW);  // N in (336, 352]: the 7^3 windows
  if (half <= 11) return plan_mma<T, D, 11, false>(p, B, H, N, nW);
  return plan_mma<T, D, 16, false>(p, B, H, N, nW);
}

template <typename T>
cudaError_t plan_mma_d(MmaPlan& p, long long B, int H, int N, int D, int nW) {
  if (D == 8) return plan_mma_ch<T, 8>(p, B, H, N, nW);
  if (D == 16) return plan_mma_ch<T, 16>(p, B, H, N, nW);
  return plan_mma_ch<T, 32>(p, B, H, N, nW);
}

template <int D, int CH, bool FULL, int KS>
cudaError_t run_tf32(const MmaPlan& p, const void* q, const void* k, const void* v, const float* bias,
                     const float* mask, void* out, float* lse, cudaStream_t stream) {
  window_attention_tf32_kernel<D, CH, FULL, KS><<<p.blocks, 2 * KS * p.rows, p.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), bias, mask,
      static_cast<float*>(out), lse, p.g);
  return cudaGetLastError();
}

// The float32 instance's shared memory: the addend tile (rows x lda), `stages` buffers of
// K and V (np rows each) and the groups' exchange (each warp's row max and sum, the partial
// outputs of all warps of a group but its first).
size_t tf32_smem(int rows, int lda, int np, int D, int stages, int ks) {
  const int kv_ld = (D == 32 ? 48 : D) + D + 4;
  return ((size_t)rows * lda + (size_t)stages * np * kv_ld + 2 * ks * rows +
          (size_t)(ks - 1) * (rows / 16) * (D / 8) * 4 * 32) * sizeof(float);
}

// The float32 plan: the most query rows a block (64, 32, 16) whose addend tile fits beside K
// and V double-buffered, else beside one buffer of them; windows a block as split_rows.
template <int D, int CH, bool FULL, int KS>
cudaError_t plan_tf32(MmaPlan& p, long long B, int H, int N, int nW) {
  const auto kernel = window_attention_tf32_kernel<D, CH, FULL, KS>;
  p.run = run_tf32<D, CH, FULL, KS>;
  const int np = (N + 7) & ~7;
  MmaGeom& g = p.g;
  g.H = H;
  g.N = N;
  g.nW = nW;
  g.per_row = (int)(B / nW);
  g.lda = np % 16 == 0 ? np + 8 : np;  // 8 rows' float2 reads in distinct banks
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p.rows = 0;
  for (int rows = 64; rows >= 16 && p.rows == 0; rows /= 2)
    for (int stages = 2; stages >= 1 && p.rows == 0; --stages)
      if (tf32_smem(rows, g.lda, np, D, stages, KS) <= (size_t)optin) {
        p.rows = rows;
        g.stages = stages;
      }
  if (p.rows == 0) return cudaErrorInvalidValue;
  p.smem = tf32_smem(p.rows, g.lda, np, D, g.stages, KS);
  g.n_qtiles = (N + p.rows - 1) / p.rows;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel, 2 * KS * p.rows, p.smem);
  if (err != cudaSuccess) return err;
  if (p.per_sm < 1) return cudaErrorInvalidValue;
  split_rows(g, (long long)sms * p.per_sm);
  const long long blocks = (long long)g.n_qtiles * H * nW * g.splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.blocks = (unsigned)blocks;
  return cudaSuccess;
}

// Four warps a row group where a warp's quarter of the keys, its Q fragments and its
// outputs fit 128 registers without a spill (D = 8, N <= 352: 16 warps a block), else two.
template <int D>
cudaError_t plan_tf32_ch(MmaPlan& p, long long B, int H, int N, int nW) {
  const int nc = (N + 7) / 8;  // 8-key chunks
  if constexpr (D == 8) {
    const int part = (nc + 3) / 4;  // the chunks of the first quarter
    if (part <= 2) return plan_tf32<D, 2, false, 4>(p, B, H, N, nW);
    if (part == 7) return plan_tf32<D, 7, true, 4>(p, B, H, N, nW);  // N in (192, 224]: the 6^3 windows
    if (part <= 7) return plan_tf32<D, 7, false, 4>(p, B, H, N, nW);
    if (part == 11) return plan_tf32<D, 11, true, 4>(p, B, H, N, nW);  // N in (320, 352]: the 7^3 windows
    if (part <= 11) return plan_tf32<D, 11, false, 4>(p, B, H, N, nW);
    return plan_tf32<D, 32, false, 2>(p, B, H, N, nW);  // N in (352, 512]
  } else {
    const int half = (nc + 1) / 2;  // the chunks of the first half
    if (half <= 4) return plan_tf32<D, 4, false, 2>(p, B, H, N, nW);
    if (half == 14) return plan_tf32<D, 14, true, 2>(p, B, H, N, nW);
    if (half <= 14) return plan_tf32<D, 14, false, 2>(p, B, H, N, nW);
    if (half == 22) return plan_tf32<D, 22, true, 2>(p, B, H, N, nW);
    if (half <= 22) return plan_tf32<D, 22, false, 2>(p, B, H, N, nW);
    return plan_tf32<D, 32, false, 2>(p, B, H, N, nW);
  }
}

cudaError_t plan_tf32_d(MmaPlan& p, long long B, int H, int N, int D, int nW) {
  if (D == 8) return plan_tf32_ch<8>(p, B, H, N, nW);
  if (D == 16) return plan_tf32_ch<16>(p, B, H, N, nW);
  return plan_tf32_ch<32>(p, B, H, N, nW);
}

// The plan of a shape on the current device (either tensor-core instance), made at its
// first launch and kept.
cudaError_t find_mma_plan(MmaPlan& p, long long B, int H, int N, int D, int nW, int dtype) {
  static std::mutex mu;
  static std::map<std::array<long long, 6>, MmaPlan> plans;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<long long, 6> key{dev, B, H, N, D, (long long)nW * 4 + dtype};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    p = it->second;
    return cudaSuccess;
  }
  const cudaError_t made = dtype == 0   ? plan_tf32_d(p, B, H, N, D, nW)
                           : dtype == 1 ? plan_mma_d<__nv_bfloat16>(p, B, H, N, D, nW)
                                        : plan_mma_d<__half>(p, B, H, N, D, nW);
  if (made == cudaSuccess) plans.emplace(key, p);
  return made;
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

Instance pick_instance(int N, int D, int dtype, bool aligned) {
  if (N > kMaxN || (D != 8 && D != 16 && D != 32)) return kGeneric;
  if (!aligned) return kFma;
  return dtype == 0 ? kTf32 : kMma;
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* bias, const float* mask, void* out,
                     float* lse, long long B, int H, int N, int D, int nW, int dtype, cudaStream_t stream) {
  const Instance inst = pick_instance(N, D, dtype, aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out));
  if (inst == kGeneric) return launch_generic<T>(q, k, v, bias, mask, out, lse, B, H, N, D, nW, stream);
  if (inst == kMma || inst == kTf32) {
    MmaPlan p;
    const cudaError_t err = find_mma_plan(p, B, H, N, D, nW, dtype);
    if (err != cudaSuccess) return err;
    return p.run(p, q, k, v, bias, mask, out, lse, stream);
  }
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, bias, mask, out, lse, B, H, N, nW, stream);
    case 16: return launch<T, 16>(q, k, v, bias, mask, out, lse, B, H, N, nW, stream);
    default: return launch<T, 32>(q, k, v, bias, mask, out, lse, B, H, N, nW, stream);
  }
}

bool valid(long long B, int H, int N, int D, int nW, bool has_mask) {
  return B > 0 && H > 0 && N > 0 && D > 0 && (!has_mask || (nW > 0 && B % nW == 0));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; mask may be null (then nW is ignored); lse
// (B, H, N) float32, or null where no log-sum-exp is wanted. Returns a cudaError_t (0 on
// success); launches on `stream` and does not synchronise.
extern "C" int monai_window_attention(const void* q, const void* k, const void* v, const void* bias,
                                      const void* mask, void* out, void* lse, long long B, int H, int N, int D,
                                      int nW, int dtype, void* stream) {
  if (!valid(B, H, N, D, nW, mask != nullptr)) return (int)cudaErrorInvalidValue;
  if (mask == nullptr) nW = 1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(mask);
  auto* lf = static_cast<float*>(lse);
  if (dtype == 0) return (int)cleared(launch_d<float>(q, k, v, bf, mf, out, lf, B, H, N, D, nW, dtype, s));
  if (dtype == 1) return (int)cleared(launch_d<__nv_bfloat16>(q, k, v, bf, mf, out, lf, B, H, N, D, nW, dtype, s));
  if (dtype == 2) return (int)cleared(launch_d<__half>(q, k, v, bf, mf, out, lf, B, H, N, D, nW, dtype, s));
  return (int)cudaErrorInvalidValue;
}

// What a launch of this shape runs, without launching it: info[0] the instance (0
// tensor-core, 1 FMA, 2 generic, 3 float32 tensor-core), info[1] the windows a block walks over, info[2] the
// blocks, info[3] the blocks an SM holds (0 where not worked out), info[4] the dynamic
// shared memory in bytes, info[5] the query rows a block. nW = 0 means no mask. Returns a
// cudaError_t.
extern "C" int monai_window_attention_plan(long long B, int H, int N, int D, int nW, int dtype, int aligned,
                                           int* info) {
  if (!valid(B, H, N, D, nW, nW > 0) || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  const Instance inst = pick_instance(N, D, dtype, aligned != 0);
  info[0] = inst;
  info[1] = 1;
  info[3] = 0;
  if (inst == kMma || inst == kTf32) {
    MmaPlan p;
    const cudaError_t err = find_mma_plan(p, B, H, N, D, nW > 0 ? nW : 1, dtype);
    if (err != cudaSuccess) return (int)cleared(err);
    info[1] = p.g.wb;
    info[2] = (int)p.blocks;
    info[3] = p.per_sm;
    info[4] = (int)p.smem;
    info[5] = p.rows;
    return 0;
  }
  const int rows = inst == kFma ? kQTile : kGQTile;
  info[2] = (int)(B * H * ((N + rows - 1) / rows));
  info[4] = (int)(inst == kFma ? 2 * (size_t)N * (D + 1) * sizeof(float) : generic_smem_bytes(D));
  info[5] = rows;
  return 0;
}
