// Fused windowed attention, backward:
//
//   S  = q k^T + bias[h] + mask[b % nW]      P = softmax(S) = exp(S - lse)
//   Di = sum_d dO[i,d] O[i,d]                dS = P o (dO v^T - D)
//   dV = round(P)^T dO     dQ = dS k     dK = dS^T q     dbias[h] = sum over windows b of dS[b,h]
//
// q, k, v, O (the forward's output) and dO are contiguous (B, H, N, D), float32, bfloat16
// or float16, q already scaled; bias (H, N, N) and mask (nW, N, N) are float32, the mask
// optional, window b using mask row b % nW; lse (B, H, N) float32 is the forward's
// log-sum-exp of each score row, written by the forward kernel under autograd. All sums
// are float32; round(P) is P rounded to the input type, as the forward rounds it before
// P.v; dq, dk and dv come out in the input type, dbias in float32. The mask gets no grad.
//
// Replaces monai_tpu/ops/pallas_window_attention.py::_vjp_bwd, the custom VJP that
// recomputes through the XLA formulation (_xla_window_attention) and lets XLA's autodiff
// form the (B, H, N, N) scores, probabilities and their grads in HBM. Here no N x N
// tensor leaves the chip.
//
// What bounds it: the five N^2 D products (S, dP, dV, dK, dQ), 5 D multiply-adds a score,
// at the float32 peak of 67 TFLOP/s; the bytes and the one exp a score are far below.
// The design computes each score's S and dP once, for all four outputs, and runs the
// products on the tensor cores' mma.sync in 3xTF32: each float32 operand x is split into
// big (x with its low 13 bits cleared, a TF32 value) and small (x - big, exact, likewise
// cleared), and a product is big.big + big.small + small.big, accumulated in float32
// (error ~2^-20 of the product: float32 precision, not TF32's). Two designs measured on
// the way (PERF.md §6): register tiles on the FMA pipe (2 x 4 and 4 x 4 a thread) load
// 0.5-0.75 words of shared memory a multiply-add and ran at the shared memory's rate; the
// split by cvt.rna.tf32 (two conversions an operand element, at 16 a clock an SM) ran at
// the conversion unit's. The masks and a subtraction take the integer and FMA pipes.
//
// - delta: Di, one warp a row.
// - main (route "tf32x3"): a block of 256 threads (8 warps) owns KT keys (a key tile) of
//   one head and walks a run of windows in the order of their mask rows; for each window
//   it walks the queries QT rows at a time (QT x KT = 2048 scores a step):
//   A. each warp computes two 16 x 8 tiles of S and of dP (m16n8k8 over d), whose
//      accumulators hold the same scores in the same threads; then P = exp2(S log2e - lse
//      log2e), round(P) and dS, which it adds into the block's (N, KT) float32 dbias tile
//      in shared memory (each cell owned by one thread) and leaves in shared memory;
//   B. dV += round(P)^T dO and dK += dS^T q (m16n8k8 over the step's rows), held in
//      registers over the window's steps, written once at its end (row splits, where a
//      warp has no tile of its own, added in order);
//   C. the step's dQ rows over the tile's keys (key splits added in order), written as the
//      key tile's float32 partial of dQ (or dQ itself where one tile holds every key).
//   The addend bias[h] + mask[row] of the tile's keys, (N, KT) float32, is staged in
//   shared memory once for each mask row the run meets (once for the run without a
//   mask): no score reads it from L2; a new mask row's is copied by cp.async while the
//   last step before it runs B and C. The next step's q, dO, lse and D, and the next
//   window's k and v, are copied by cp.async (float32; bfloat16 and float16 through
//   registers, converted) into second buffers while this step computes. KT is 64 where
//   the two (N, KT) tiles fit the block's shared memory (N up to 349 at D = 16, 361 at D =
//   8), else 32 or 16; windows are split into runs for the fewest waves of resident blocks
//   times the windows a run.
// - sum: dQ from the key tiles' partials and dbias from the runs' partials, each added in
//   order (skipped where there is one of each).
//
// Deterministic: no atomics. Each output element is a sum that one thread (or one mma
// accumulator) adds up in a fixed order.
//
// Head dims up to 32 (every SwinUNETR up to feature size 96, zero-padded to 8, 16 or 32),
// N up to what the (N, 16) tiles leave of the shared memory (~1400 at D <= 16); other
// shapes are refused.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>

#include "mma_sync.cuh"
#include "runtime_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 32;  // warps a block (delta: a row a warp)
constexpr int kScores = 2048;           // QT x KT: the scores of one step of a block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta, long long rows,
             int D) {
  const long long row = (long long)blockIdx.x * kGroups + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_float(dout[row * D + d]), to_float(out[row * D + d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// 4 bytes from global to shared memory, asynchronously; zeros where !ok (src not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// 2^x on the special-function unit (relative error ~2^-22; 0 below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The main launch's geometry for a key tile of KT keys and head dim DP.
template <int KT, int DP>
struct Geo {
  static constexpr int QT = kScores / KT;           // query rows a step
  static constexpr int DS = DP + 4;                 // floats a row of q, dO, k, v in shared memory
  static constexpr int RS = DP == 8 ? 24 : DP + 8;  // floats a row of dQ's key-split partials
  static constexpr int NT = KT / 8;                 // A: n-tiles (of 8 keys) of a step; two a warp
  // B: dV and dK tiles (16 keys x 8 d), a warp TB / 8 of them, or one over 1 / KB of the rows
  static constexpr int MB = KT / 16, NB = DP / 8, TB = 2 * MB * NB;
  static constexpr int WB = TB >= 8 ? TB / 8 : 1, KB = TB >= 8 ? 1 : 8 / TB;
  // C: dQ tiles (16 rows x 8 d), a warp TC / 8 of them, or one over 1 / KC of the keys
  static constexpr int NC = DP / 8, TC = QT / 16 * NC;
  static constexpr int WC = TC >= 8 ? TC / 8 : 1, KC = TC >= 8 ? 1 : 8 / TC;
  static constexpr int SW = KT >= 32 ? 3 : 1;  // the column swizzle's row bits (see swz)
  // per thread: the next step's q and dO values, the next window's k and v values
  static constexpr int QV = QT * DP / kThreads;
  static constexpr int KV = (KT * DP + kThreads - 1) / kThreads;
  static_assert(QV >= 1 && QT <= kThreads && NT % 2 == 0, "tile");
  static_assert(QT / KB % 8 == 0 && KT / KC % 8 == 0 && (WB == 1 || WB <= NB) && (WC == 1 || WC <= NC), "splits");
  static_assert(2 * KB * KT * DP <= 2 * kScores, "dK and dV's row splits fit round(P) and dS's buffers");
};

// The main launch's shared memory: the (N, KT) addend and dbias tiles; k, v, q and dO, two
// buffers each; round(P) and dS; dQ's key-split partials; lse and D, two buffers each.
__host__ __device__ constexpr size_t main_smem_bytes(int N, int KT, int DP) {
  return ((size_t)2 * N * KT + 4 * KT * (DP + 4) + 4 * (kScores / KT) * (DP + 4) + 2 * kScores
          + (kScores / KT / 16 * (DP / 8) >= 8 ? 1 : 8 / (kScores / KT / 16 * (DP / 8))) * (kScores / KT)
                * (DP == 8 ? 24 : DP + 8)
          + 4 * (kScores / KT)) * sizeof(float);
}

// A column of the (rows, KT) tiles in shared memory (addend, dbias, round(P), dS): column j
// of row i is stored at j ^ 8 (i mod 4) (KT >= 32; i mod 2 at KT = 16), so that the eight
// rows of an accumulator's float2 and of an A operand's column fall in different banks.
template <int KT>
__device__ __forceinline__ int swz(int i, int j) {
  return j ^ ((i & Geo<KT, 8>::SW) << 3);
}

template <typename T, int KT, int DP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ bias, const float* __restrict__ mask, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dq_part,
                T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias_out, long long B, int H, int N,
                int D, int nW, int per_row, int nkt, int run, bool vec) {
  using G = Geo<KT, DP>;
  constexpr int QT = G::QT, DS = G::DS, RS = G::RS;
  constexpr bool kAsync = std::is_same<T, float>::value;  // q, dO, k, v by cp.async (else converted)
  extern __shared__ __align__(16) float smem[];
  float* addS = smem;                       // N x KT: bias + mask of the tile's keys (swizzled)
  float* dbS = addS + (size_t)N * KT;       // N x KT: the run's sum of dS (swizzled)
  float* kS = dbS + (size_t)N * KT;         // 2 x KT x DS: k
  float* vS = kS + 2 * KT * DS;             // 2 x KT x DS
  float* qS = vS + 2 * KT * DS;             // 2 x QT x DS
  float* gS = qS + 2 * QT * DS;             // 2 x QT x DS: dO
  float* pS = gS + 2 * QT * DS;             // QT x KT: round(P) (swizzled)
  float* sS = pS + QT * KT;                 // QT x KT: dS (swizzled)
  float* red = sS + QT * KT;                // KC x QT x RS: dQ's key-split partials
  float* lS = red + G::KC * QT * RS;        // 2 x QT: lse (0 past N)
  float* dlS = lS + 2 * QT;                 // 2 x QT: D (0 past N)

  const int t = threadIdx.x, warp = t >> 5, g = (t & 31) >> 2, tq = t & 3;
  long long blk = blockIdx.x;
  const int kt = (int)(blk % nkt);
  blk /= nkt;
  const int h = (int)(blk % H);
  const long long split = blk / H;
  const long long p0 = split * run, p1 = min(B, p0 + run);
  const int chunks = (N + QT - 1) / QT;
  const long long steps = (p1 - p0) * chunks;
  const int j_base = kt * KT, keys = min(KT, N - j_base);
  const long long bhn_d = B * H * (long long)N * D;  // elements of dq

  // the window of run position p: mask row m = p / per_row, window m + nW (p % per_row)
  auto window_bh = [&](long long p) -> long long {
    const long long m = p / per_row, tt = p % per_row;
    return (m + (long long)nW * tt) * H + h;
  };
  // the addend of mask row m: the mask's rows by cp.async (asynchronous; -inf past N's keys),
  // then, once this thread's copies have landed, bias[h] added to the same elements
  auto copy_mask = [&](long long m) {
    const float* mrow = mask + m * N * (long long)N + j_base;
    for (int idx = t; idx < N * KT; idx += kThreads) {
      const int i = idx / KT, j = idx - i * KT;
      float* dst = addS + i * KT + swz<KT>(i, j);
      if (j < keys) cp_async4(dst, mrow + (long long)i * N + j, true);
      else *dst = -INFINITY;
    }
  };
  auto add_bias = [&](bool with_mask) {
    const float* __restrict__ brow = bias + (long long)h * N * N + j_base;
    constexpr int kAtOnce = 16;
    for (int idx0 = t; idx0 < N * KT; idx0 += kAtOnce * kThreads) {
      float b[kAtOnce];
#pragma unroll
      for (int r = 0; r < kAtOnce; ++r) {
        const int idx = idx0 + r * kThreads, i = idx / KT, j = idx - i * KT;
        b[r] = idx < N * KT && j < keys ? brow[(long long)i * N + j] : -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < kAtOnce; ++r) {
        const int idx = idx0 + r * kThreads, i = idx / KT, j = idx - i * KT;
        if (idx < N * KT) {
          float* dst = addS + i * KT + swz<KT>(i, j);
          *dst = with_mask && j < keys ? *dst + b[r] : b[r];
        }
      }
    }
  };

  // the next step's rows and the next window's keys: by cp.async in float32, else through
  // registers, converted
  T qn[kAsync ? 1 : G::QV], gn[kAsync ? 1 : G::QV], kn[kAsync ? 1 : G::KV], vn[kAsync ? 1 : G::KV];
  auto load_rows = [&](long long bh, int c0, int buf) {
    if (t < QT) {
      const bool ok = c0 + t < N;
      const long long off = ok ? bh * N + c0 + t : 0;
      cp_async4(lS + buf * QT + t, lse + off, ok);
      cp_async4(dlS + buf * QT + t, delta + off, ok);
    }
    if (kAsync && vec) {  // 16 bytes a copy: D a multiple of 4, q, k, v and dO 16-byte aligned
      for (int e = t; e < QT * DP / 2; e += kThreads) {
        const int x = e / (QT * DP / 4), c4 = e - x * (QT * DP / 4), i = c4 / (DP / 4), d = 4 * (c4 - i * (DP / 4));
        const int row = c0 + i, bytes = row < N ? 4 * max(0, min(4, D - d)) : 0;
        const float* src = reinterpret_cast<const float*>(x ? dout : q) + (bytes ? (bh * N + row) * D + d : 0);
        cp_async16((x ? gS : qS) + (buf * QT + i) * DS + d, src, bytes);
      }
      return;
    }
#pragma unroll
    for (int r = 0; r < G::QV; ++r) {
      const int e = t + r * kThreads, i = e / DP, d = e - i * DP, row = c0 + i;
      const bool ok = row < N && d < D;
      const long long off = ok ? (bh * N + row) * D + d : 0;
      if constexpr (kAsync) {
        cp_async4(qS + (buf * QT + i) * DS + d, reinterpret_cast<const float*>(q) + off, ok);
        cp_async4(gS + (buf * QT + i) * DS + d, reinterpret_cast<const float*>(dout) + off, ok);
      } else {
        qn[r] = ok ? q[off] : from_float<T>(0.0f);
        gn[r] = ok ? dout[off] : from_float<T>(0.0f);
      }
    }
  };
  auto store_rows = [&](int buf) {  // the converted path's registers into shared memory
    if constexpr (!kAsync) {
#pragma unroll
      for (int r = 0; r < G::QV; ++r) {
        const int e = t + r * kThreads, i = e / DP, d = e - i * DP;
        qS[(buf * QT + i) * DS + d] = to_float(qn[r]);
        gS[(buf * QT + i) * DS + d] = to_float(gn[r]);
      }
    }
  };
  auto load_keys = [&](long long bh, int buf) {
    if (kAsync && vec) {
      for (int e = t; e < KT * DP / 2; e += kThreads) {
        const int x = e / (KT * DP / 4), c4 = e - x * (KT * DP / 4), j = c4 / (DP / 4), d = 4 * (c4 - j * (DP / 4));
        const int bytes = j < keys ? 4 * max(0, min(4, D - d)) : 0;
        const float* src = reinterpret_cast<const float*>(x ? v : k) + (bytes ? (bh * N + j_base + j) * D + d : 0);
        cp_async16((x ? vS : kS) + (buf * KT + j) * DS + d, src, bytes);
      }
      return;
    }
#pragma unroll
    for (int r = 0; r < G::KV; ++r) {
      const int e = t + r * kThreads, j = e / DP, d = e - j * DP;
      const bool ok = e < KT * DP && j < keys && d < D;
      const long long off = ok ? (bh * N + j_base + j) * D + d : 0;
      if constexpr (kAsync) {
        if (e < KT * DP) {
          cp_async4(kS + (buf * KT + j) * DS + d, reinterpret_cast<const float*>(k) + off, ok);
          cp_async4(vS + (buf * KT + j) * DS + d, reinterpret_cast<const float*>(v) + off, ok);
        }
      } else {
        kn[r] = ok ? k[off] : from_float<T>(0.0f);
        vn[r] = ok ? v[off] : from_float<T>(0.0f);
      }
    }
  };
  auto store_keys = [&](int buf) {
    if constexpr (!kAsync) {
#pragma unroll
      for (int r = 0; r < G::KV; ++r) {
        const int e = t + r * kThreads, j = e / DP, d = e - j * DP;
        if (e < KT * DP) {
          kS[(buf * KT + j) * DS + d] = to_float(kn[r]);
          vS[(buf * KT + j) * DS + d] = to_float(vn[r]);
        }
      }
    }
  };
  // operand fragments from shared memory, split: A of a row-major tile (rows r0 + g, + 8;
  // columns c0 + tq, + 4), A of a transposed one (element (m, k) at x[k][m]), B of a
  // row-major (k, n) tile (element (k, n) at x[k][n]) and B whose (k, n) is at x[n][k]
  auto frag_a = [&](const float* x, int ld, int r0, int c0, FragA& f) {
    split_tf32(x[(r0 + g) * ld + c0 + tq], f.big[0], f.small[0]);
    split_tf32(x[(r0 + g + 8) * ld + c0 + tq], f.big[1], f.small[1]);
    split_tf32(x[(r0 + g) * ld + c0 + tq + 4], f.big[2], f.small[2]);
    split_tf32(x[(r0 + g + 8) * ld + c0 + tq + 4], f.big[3], f.small[3]);
  };
  auto frag_a_swz = [&](const float* x, int r0, int c0, FragA& f) {  // a swizzled (QT, KT) tile
    const int ra = r0 + g, rb = r0 + g + 8, ca = c0 + tq, cb = c0 + tq + 4;
    split_tf32(x[ra * KT + swz<KT>(ra, ca)], f.big[0], f.small[0]);
    split_tf32(x[rb * KT + swz<KT>(rb, ca)], f.big[1], f.small[1]);
    split_tf32(x[ra * KT + swz<KT>(ra, cb)], f.big[2], f.small[2]);
    split_tf32(x[rb * KT + swz<KT>(rb, cb)], f.big[3], f.small[3]);
  };
  auto frag_at_swz = [&](const float* x, int m0, int k0, FragA& f) {  // the transpose of one
    const int r_a = k0 + tq, r_b = k0 + tq + 4, c_a = m0 + g, c_b = m0 + g + 8;
    split_tf32(x[r_a * KT + swz<KT>(r_a, c_a)], f.big[0], f.small[0]);
    split_tf32(x[r_a * KT + swz<KT>(r_a, c_b)], f.big[1], f.small[1]);
    split_tf32(x[r_b * KT + swz<KT>(r_b, c_a)], f.big[2], f.small[2]);
    split_tf32(x[r_b * KT + swz<KT>(r_b, c_b)], f.big[3], f.small[3]);
  };
  auto frag_b_kn = [&](const float* x, int ld, int k0, int n0, FragB& f) {
    split_tf32(x[(k0 + tq) * ld + n0 + g], f.big[0], f.small[0]);
    split_tf32(x[(k0 + tq + 4) * ld + n0 + g], f.big[1], f.small[1]);
  };
  auto frag_b_nk = [&](const float* x, int ld, int k0, int n0, FragB& f) {
    split_tf32(x[(n0 + g) * ld + k0 + tq], f.big[0], f.small[0]);
    split_tf32(x[(n0 + g) * ld + k0 + tq + 4], f.big[1], f.small[1]);
  };

  // the first window
  long long bh = window_bh(p0);
  load_rows(bh, 0, 0);
  load_keys(bh, 0);
  store_rows(0);
  store_keys(0);
  if (mask != nullptr) copy_mask(p0 / per_row);
  for (int idx = t; idx < N * KT; idx += kThreads) dbS[idx] = 0.0f;
  cp_async_wait_all();
  add_bias(mask != nullptr);

  // A: this warp's two tiles of S and dP (16 rows, 8 keys each, one row tile)
  const int a_m = 16 * (2 * warp / G::NT), a_n = 8 * (2 * warp % G::NT);
  // B: this warp's dV (first) or dK tiles, a run of consecutive d tiles of one 16-key tile,
  // over the rows [b_k0, b_k0 + QT / KB) of a step
  const int b_tau = G::TB >= 8 ? warp * G::WB : warp % G::TB;
  const int b_prod = b_tau / (G::MB * G::NB), b_m = 16 * (b_tau % (G::MB * G::NB) / G::NB);
  const int b_n = 8 * (b_tau % G::NB), b_part = G::TB >= 8 ? 0 : warp / G::TB, b_k0 = b_part * (QT / G::KB);
  // C: this warp's dQ tiles, consecutive d tiles of one 16-row tile, over the keys
  // [c_k0, c_k0 + KT / KC)
  const int c_tau = G::TC >= 8 ? warp * G::WC : warp % G::TC;
  const int c_m = 16 * (c_tau / G::NC), c_n = 8 * (c_tau % G::NC);
  const int c_part = G::TC >= 8 ? 0 : warp / G::TC, c_k0 = c_part * (KT / G::KC);
  // dV or dK over the window's rows so far, this row split's share: main and correction (by
  // k-step parity) accumulators
  float acc[G::WB][4], acc2[2][G::WB][4];
#pragma unroll
  for (int u = 0; u < G::WB; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[u][x] = acc2[0][u][x] = acc2[1][u][x] = 0.0f;

  long long p = p0;
  int c = 0, kb = 0;  // the step's chunk of rows; the window's buffer of k and v
  for (long long s = 0; s < steps; ++s) {
    const int buf = (int)(s & 1);
    const int c0 = c * QT;
    const bool last_chunk = c + 1 == chunks;
    const long long pn = last_chunk ? p + 1 : p;
    const bool has_next = s + 1 < steps;
    const long long bhn = has_next && last_chunk ? window_bh(pn) : bh;
    // the next window starts a mask row: its addend replaces this one after phase A
    const bool new_row = has_next && last_chunk && mask != nullptr && pn / per_row != p / per_row;
    __syncthreads();  // step s's rows and keys are staged; step s-1 is consumed
    if (has_next) {
      load_rows(bhn, last_chunk ? 0 : c0 + QT, buf ^ 1);
      if (last_chunk) load_keys(bhn, kb ^ 1);
    }
    const float* qb = qS + buf * QT * DS;
    const float* gb = gS + buf * QT * DS;
    const float* kc = kS + kb * KT * DS;
    const float* vc = vS + kb * KT * DS;

    // A: S = q k^T and dP = dO v^T, then P, round(P), dS and the dbias tile
    {
      float sc[2][4], dp[2][4], sc2[2][4], dp2[2][4];  // main and correction accumulators
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[u][x] = dp[u][x] = sc2[u][x] = dp2[u][x] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < DP; k0 += 8) {
        FragA fq, fg;
        frag_a(qb, DS, a_m, k0, fq);
        frag_a(gb, DS, a_m, k0, fg);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          FragB fk, fv;
          frag_b_nk(kc, DS, k0, a_n + 8 * u, fk);
          frag_b_nk(vc, DS, k0, a_n + 8 * u, fv);
          mma3(sc[u], sc2[u], fq, fk);
          mma3(dp[u], dp2[u], fg, fv);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          sc[u][x] += sc2[u][x];
          dp[u][x] += dp2[u][x];
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int il = a_m + g + 8 * hf, i = c0 + il, jc = a_n + 8 * u + 2 * tq;
          const float2 ad = *reinterpret_cast<const float2*>(addS + min(i, N - 1) * KT + swz<KT>(min(i, N - 1), jc));
          const float ll = i < N ? lS[buf * QT + il] * kLog2e : INFINITY, dl = dlS[buf * QT + il];  // past N: P = 0
          const float p0v = ex2(fmaf(sc[u][2 * hf] + ad.x, kLog2e, -ll));
          const float p1v = ex2(fmaf(sc[u][2 * hf + 1] + ad.y, kLog2e, -ll));
          const float d0v = p0v * (dp[u][2 * hf] - dl), d1v = p1v * (dp[u][2 * hf + 1] - dl);
          // round(P): the forward's p in the input type
          *reinterpret_cast<float2*>(pS + il * KT + swz<KT>(il, jc)) =
              make_float2(to_float(from_float<T>(p0v)), to_float(from_float<T>(p1v)));
          *reinterpret_cast<float2*>(sS + il * KT + swz<KT>(il, jc)) = make_float2(d0v, d1v);
          if (i < N) {
            float2* db = reinterpret_cast<float2*>(dbS + i * KT + swz<KT>(i, jc));
            const float2 old = *db;
            *db = make_float2(old.x + d0v, old.y + d1v);
          }
        }
    }
    __syncthreads();  // round(P) and dS are in shared memory; the addend is read
    if (new_row) copy_mask(pn / per_row);

    // B: dV += round(P)^T dO, dK += dS^T q over this warp's rows
    {
      const float* am = b_prod ? sS : pS;
      const float* bm = b_prod ? qb : gb;
#pragma unroll
      for (int ks = 0; ks < QT / G::KB / 8; ++ks) {
        const int k0 = b_k0 + 8 * ks;
        FragA fa;
        frag_at_swz(am, b_m, k0, fa);
#pragma unroll
        for (int u = 0; u < G::WB; ++u) {
          FragB fb;
          frag_b_kn(bm, DS, k0, b_n + 8 * u, fb);
          mma3(acc[u], acc2[ks & 1][u], fa, fb);
        }
      }
    }
    // C: this warp's share of dQ's rows
    float cq[G::WC][4];  // the share of key split c_part
    {
      float cq2[2][G::WC][4];  // correction accumulators, by k-step parity
#pragma unroll
      for (int u = 0; u < G::WC; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) cq[u][x] = cq2[0][u][x] = cq2[1][u][x] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KT / G::KC / 8; ++ks) {
        const int k0 = c_k0 + 8 * ks;
        FragA fa;
        frag_a_swz(sS, c_m, k0, fa);
#pragma unroll
        for (int u = 0; u < G::WC; ++u) {
          FragB fb;
          frag_b_kn(kc, DS, k0, c_n + 8 * u, fb);
          mma3(cq[u], cq2[ks & 1][u], fa, fb);
        }
      }
#pragma unroll
      for (int u = 0; u < G::WC; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) cq[u][x] += cq2[0][u][x] + cq2[1][u][x];
      if (c_part > 0)  // the later key splits' shares to shared memory, for split 0's warps
#pragma unroll
        for (int u = 0; u < G::WC; ++u)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(red + (c_part * QT + c_m + g + 8 * hf) * RS + c_n + 8 * u + 2 * tq) =
                make_float2(cq[u][2 * hf], cq[u][2 * hf + 1]);
    }
    __syncthreads();  // the key splits' dQ rows are in shared memory; A-C are done

    // dQ's rows: split 0's warps add the later splits' shares in order and write the tile's
    // partial, or dQ where one tile holds every key
    if (c_part == 0) {
#pragma unroll
      for (int u = 0; u < G::WC; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int il = c_m + g + 8 * hf, row = c0 + il, col = c_n + 8 * u + 2 * tq;
          float v0 = cq[u][2 * hf], v1 = cq[u][2 * hf + 1];
#pragma unroll
          for (int x = 1; x < G::KC; ++x) {
            const float2 o = *reinterpret_cast<const float2*>(red + (x * QT + il) * RS + col);
            v0 += o.x;
            v1 += o.y;
          }
          if (row < N) {
            const long long off = (bh * N + row) * D + col;
            if (nkt == 1) {
              if (col < D) dq[off] = from_float<T>(v0);
              if (col + 1 < D) dq[off + 1] = from_float<T>(v1);
            } else {
              if (col < D) dq_part[kt * bhn_d + off] = v0;
              if (col + 1 < D) dq_part[kt * bhn_d + off + 1] = v1;
            }
          }
        }
    }
    if (has_next) store_rows(buf ^ 1);
    cp_async_wait_all();  // the next step's rows (keys, mask) by this thread
    if (last_chunk) {
      // dK and dV: the row splits added in order, written once
      float* kv = pS;  // 2 x KB x KT x DP floats: round(P) and dS are consumed
#pragma unroll
      for (int u = 0; u < G::WB; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x0 = 2 * hf, x1 = 2 * hf + 1;
          *reinterpret_cast<float2*>(kv + ((b_prod * G::KB + b_part) * KT + b_m + g + 8 * hf) * DP + b_n + 8 * u +
                                     2 * tq) = make_float2(acc[u][x0] + (acc2[0][u][x0] + acc2[1][u][x0]),
                                                           acc[u][x1] + (acc2[0][u][x1] + acc2[1][u][x1]));
          acc[u][x0] = acc[u][x1] = acc2[0][u][x0] = acc2[0][u][x1] = acc2[1][u][x0] = acc2[1][u][x1] = 0.0f;
        }
      __syncthreads();
      for (int o = t; o < 2 * KT * DP; o += kThreads) {
        const int prod = o / (KT * DP), rem = o - prod * KT * DP, j = rem / DP, d = rem - j * DP;
        float sum = 0.0f;
#pragma unroll
        for (int x = 0; x < G::KB; ++x) sum += kv[((prod * G::KB + x) * KT + j) * DP + d];
        if (j < keys && d < D) (prod ? dk : dv)[(bh * N + j_base + j) * D + d] = from_float<T>(sum);
      }
      if (has_next) store_keys(kb ^ 1);
      if (new_row) add_bias(true);
      kb ^= 1;
      c = 0;
    } else {
      ++c;
    }
    p = pn;
    bh = bhn;
  }
  __syncthreads();
  // the run's partial of dbias (dbias itself where one run covers every window)
  float* part = dbias_out + (split * H + h) * (long long)N * N + j_base;
  for (int idx = t; idx < N * KT; idx += kThreads) {
    const int i = idx / KT, j = idx - i * KT;
    if (j < keys) part[(long long)i * N + j] = dbS[i * KT + swz<KT>(i, j)];
  }
}

// dq from the key tiles' partials and dbias from the runs' partials, each in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_sum_kernel(const float* __restrict__ dq_part, T* __restrict__ dq, long long nq, int nkt,
           const float* __restrict__ db_part, float* __restrict__ dbias, long long nb, int splits) {
  long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (nkt > 1) {
    if (idx < nq) {
      float acc = 0.0f;
      for (int x = 0; x < nkt; ++x) acc += dq_part[x * nq + idx];
      dq[idx] = from_float<T>(acc);
      return;
    }
    idx -= nq;
  }
  if (splits > 1 && idx < nb) {
    float acc = 0.0f;
    for (int x = 0; x < splits; ++x) acc += db_part[x * nb + idx];
    dbias[idx] = acc;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

int padded_d(int D) { return D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 0; }

struct Plan {
  int route;      // 0: "tf32x3", the one route
  int dp;         // the instance's head dim, D rounded up to 8, 16 or 32
  int kt, qt;     // keys a block, query rows a step
  int nkt;        // key tiles (dq partials where more than one)
  int chunks;     // steps a window
  int threads;
  size_t smem;    // the main launch's dynamic shared memory
  int resident;   // main blocks an SM holds
  int run;        // windows a block walks over
  int splits;     // runs (dbias partials where more than one)
  long long blocks;
  int launches;   // CUDA launches a call
};

// Runs of windows for the fewest waves of resident blocks times the windows a run, plus
// one for a block's fixed costs (its first staging and its dbias partial); the fewest
// runs of those.
int pick_splits(long long B, long long base, long long slots) {
  long long best = -1, splits = 1;
  for (long long s = 1; s <= B; ++s) {
    const long long run = cdiv(B, s), n = cdiv(B, run);
    if (n != s) continue;
    const long long cost = cdiv(base * n, slots) * (run + 1);
    if (best < 0 || cost < best) {
      best = cost;
      splits = n;
    }
  }
  return (int)splits;
}

template <typename T, int KT, int DP>
cudaError_t plan_inst(Plan& p, long long B, int H, int sms, int optin) {
  const auto kernel = attn_bwd_kernel<T, KT, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.resident, kernel, kThreads, p.smem);
  if (err != cudaSuccess) return err;
  if (p.resident < 1) return cudaErrorInvalidValue;
  const long long base = (long long)H * p.nkt;
  p.splits = pick_splits(B, base, (long long)sms * p.resident);
  p.run = (int)cdiv(B, p.splits);
  p.blocks = base * p.splits;
  p.launches = 2 + (p.nkt > 1 || p.splits > 1 ? 1 : 0);
  return p.blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T, int DP>
cudaError_t plan_dp(Plan& p, long long B, int H, int sms, int optin) {
  switch (p.kt) {
    case 64: return plan_inst<T, 64, DP>(p, B, H, sms, optin);
    case 32: return plan_inst<T, 32, DP>(p, B, H, sms, optin);
    default: return plan_inst<T, 16, DP>(p, B, H, sms, optin);
  }
}

template <typename T>
cudaError_t make_plan(Plan& p, long long B, int H, int N, int D) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p.route = 0;
  p.dp = padded_d(D);
  if (p.dp == 0) return cudaErrorInvalidValue;
  p.kt = 0;
  for (const int kt : {64, 32, 16}) {  // the widest key tile whose (N, KT) tiles fit
    if (main_smem_bytes(N, kt, p.dp) <= (size_t)optin) {
      p.kt = kt;
      break;
    }
  }
  if (p.kt == 0) return cudaErrorInvalidValue;
  p.qt = kScores / p.kt;
  p.nkt = (int)cdiv(N, p.kt);
  p.chunks = (int)cdiv(N, p.qt);
  p.threads = kThreads;
  p.smem = main_smem_bytes(N, p.kt, p.dp);
  switch (p.dp) {
    case 8: return plan_dp<T, 8>(p, B, H, sms, optin);
    case 16: return plan_dp<T, 16>(p, B, H, sms, optin);
    default: return plan_dp<T, 32>(p, B, H, sms, optin);
  }
}

// The plan of a shape on the current device, made at its first launch and kept.
cudaError_t plan_for(Plan& p, long long B, int H, int N, int D, int dtype) {
  static std::mutex mu;
  static std::map<std::array<long long, 6>, Plan> plans;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::array<long long, 6> key{dev, B, H, N, D, dtype};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    p = it->second;
    return cudaSuccess;
  }
  if (dtype == 0) err = make_plan<float>(p, B, H, N, D);
  else if (dtype == 1) err = make_plan<__nv_bfloat16>(p, B, H, N, D);
  else if (dtype == 2) err = make_plan<__half>(p, B, H, N, D);
  else err = cudaErrorInvalidValue;
  if (err == cudaSuccess) plans.emplace(key, p);
  return err;
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float *bias, *mask, *lse;
  float* delta;
  void *dq, *dk, *dv;
  float *dbias, *dq_part, *db_part;
  long long B;
  int H, N, D, nW;
};

template <typename T, int KT, int DP>
cudaError_t run_inst(const Plan& p, const Args& a, cudaStream_t stream) {
  const int per_row = (int)(a.B / a.nW);
  // float32 rows of whole 16-byte pieces from 16-byte aligned tensors are copied 16 bytes at a time
  const bool vec = a.D % 4 == 0 && ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                                     reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout)) & 15) == 0;
  attn_bwd_kernel<T, KT, DP><<<(unsigned)p.blocks, kThreads, p.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.bias, a.mask, a.lse, a.delta, static_cast<T*>(a.dq), a.dq_part,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), p.splits > 1 ? a.db_part : a.dbias, a.B, a.H, a.N, a.D, a.nW,
      per_row, p.nkt, p.run, vec);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t run_dp(const Plan& p, const Args& a, cudaStream_t stream) {
  switch (p.kt) {
    case 64: return run_inst<T, 64, DP>(p, a, stream);
    case 32: return run_inst<T, 32, DP>(p, a, stream);
    default: return run_inst<T, 16, DP>(p, a, stream);
  }
}

template <typename T>
cudaError_t run_t(const Plan& p, const Args& a, cudaStream_t stream, int* launched) {
  const long long rows = a.B * a.H * a.N;
  delta_kernel<T><<<(unsigned)cdiv(rows, kGroups), kThreads, 0, stream>>>(static_cast<const T*>(a.out),
                                                                            static_cast<const T*>(a.dout), a.delta,
                                                                            rows, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;
  switch (p.dp) {
    case 8: err = run_dp<T, 8>(p, a, stream); break;
    case 16: err = run_dp<T, 16>(p, a, stream); break;
    default: err = run_dp<T, 32>(p, a, stream); break;
  }
  if (err != cudaSuccess) return err;
  *launched = 2;
  if (p.launches == 2) return cudaSuccess;
  const long long nq = p.nkt > 1 ? rows * a.D : 0, nb = p.splits > 1 ? (long long)a.H * a.N * a.N : 0;
  attn_bwd_sum_kernel<T><<<(unsigned)cdiv(nq + nb, kThreads), kThreads, 0, stream>>>(
      a.dq_part, static_cast<T*>(a.dq), nq, p.nkt, a.db_part, a.dbias, nb, p.splits);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 3;
  return err;
}

bool valid(long long B, int H, int N, int D, int nW) {
  return B > 0 && H > 0 && N > 0 && D > 0 && nW > 0 && B % nW == 0;
}

}  // namespace

// What a backward of this shape launches. info (16 long longs): the route (0, "tf32x3"),
// the instance's head dim (8, 16 or 32), the key tile, the query rows a step, the key
// tiles, the steps a window, the threads, the main launch's dynamic shared memory in
// bytes, the main blocks an SM holds, the windows a block walks over, the runs, the
// main blocks, the dq partials (the key tiles where more than one, else 0), the dbias
// partials (the runs where more than one, else 0), the cluster size (1: no clusters) and
// the CUDA launches. nW = 0 means no mask. Returns a cudaError_t: cudaErrorInvalidValue
// (1) for a shape the kernel refuses (D > 32, or N past the shared memory).
extern "C" int monai_window_attention_bwd_plan(long long B, int H, int N, int D, int nW, int dtype,
                                               long long* info) {
  if (nW == 0) nW = 1;
  if (!valid(B, H, N, D, nW)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_for(p, B, H, N, D, dtype);
  if (err != cudaSuccess) return (int)cleared(err);
  const long long vals[16] = {p.route, p.dp, p.kt, p.qt, p.nkt, p.chunks, p.threads, (long long)p.smem,
                              p.resident, p.run, p.splits, p.blocks, p.nkt > 1 ? p.nkt : 0,
                              p.splits > 1 ? p.splits : 0, 1, p.launches};
  for (int x = 0; x < 16; ++x) info[x] = vals[x];
  return 0;
}

// The backward. delta is (B, H, N) float32 scratch; dq_part is (key tiles, B, H, N, D)
// float32 scratch where the plan has more than one key tile, db_part (runs, H, N, N)
// float32 scratch where it has more than one run (else unused, may be null). mask may be
// null (then nW is ignored). dtype: 0 = float32, 1 = bfloat16, 2 = float16. Launches on
// `stream` and does not synchronise; ran[0] is the route it ran and ran[1] the CUDA
// launches it made. Returns a cudaError_t.
extern "C" int monai_window_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                          const void* mask, const void* out, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, void* dbias, void* dq_part,
                                          void* db_part, long long B, int H, int N, int D, int nW, int dtype,
                                          void* stream, int* ran) {
  ran[0] = -1;
  ran[1] = 0;
  if (mask == nullptr) nW = 1;
  if (!valid(B, H, N, D, nW)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_for(p, B, H, N, D, dtype);
  if (err != cudaSuccess) return (int)cleared(err);
  if ((p.nkt > 1 && dq_part == nullptr) || (p.splits > 1 && db_part == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, dout, static_cast<const float*>(bias), static_cast<const float*>(mask),
               static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv, static_cast<float*>(dbias),
               static_cast<float*>(dq_part), static_cast<float*>(db_part), B, H, N, D, nW};
  const auto s = static_cast<cudaStream_t>(stream);
  ran[0] = p.route;
  if (dtype == 0) err = run_t<float>(p, a, s, &ran[1]);
  else if (dtype == 1) err = run_t<__nv_bfloat16>(p, a, s, &ran[1]);
  else err = run_t<__half>(p, a, s, &ran[1]);
  return (int)cleared(err);
}
