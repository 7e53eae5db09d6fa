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
// tensor leaves the chip: each launch recomputes its scores from q, k and the addend.
//
// Deterministic: no atomics. Each output element is a sum that one thread, or one block
// in a fixed order, adds up.
//
// - delta: Di, one warp a row.
// - dkdv: a block of 8 warps owns 32 keys (a lane each) of one (window, head) and walks
//   over all the window's queries, staged 64 rows at a time in shared memory as float32;
//   warp g takes the rows g, g + 8, ..., so each lane adds its key's dK and dV over an
//   eighth of the queries in registers, and the eight partial sums are added in warp
//   order at the end. The grid runs the windows of one mask row together, so that the
//   row's (N, N) mask stays in L2 while its windows and heads read it.
// - dq: a block owns 32 query rows (a lane each) of one head and walks over a run of
//   windows, in the order of their mask rows; warp g takes the keys j = g mod 8. The
//   addend bias[h] + mask[row] of its 32 rows is staged once per mask row in shared
//   memory, transposed (key-major, 33 words a key) so that a warp's 32 rows read 32
//   banks; K and V of each window are staged 64 keys at a time. dQ's eight partials are
//   added in warp order after each window. dS is summed over the run's windows into a
//   float32 tile in shared memory (each (key, row) owned by one thread, added window by
//   window), written as the run's partial of dbias.
// - dbias: the runs' partials added in run order (skipped where one run covers all).
//
// What bounds it: the products, 4 D FMAs a score in each of dkdv and dq (8 D in all,
// against the forward's 2 D), and two exps a score, all on the FMA pipes in float32 in
// every input type. The tensor cores (mma.sync for bfloat16 and float16, as the forward
// uses them), wgmma and TMA are left for later.
//
// Head dims up to 32 (every SwinUNETR up to feature size 96) and N up to what the dq
// launch's two (N, 33) float32 tiles leave of the shared memory (~800 at D = 32); other
// shapes are refused.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <array>
#include <cmath>
#include <map>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 32;  // warps a block
constexpr int kRows = 32;               // keys (dkdv) or query rows (dq) a block, one a lane
constexpr int kChunk = 64;              // rows staged a step
constexpr int kLdT = kRows + 1;         // words a key in the transposed tiles

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

// rows x DP float32 tile from rows of D elements; zero past `valid` rows and past D
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int valid, int D) {
  for (int idx = threadIdx.x; idx < kChunk * DP; idx += kThreads) {
    const int r = idx / DP, d = idx - r * DP;
    dst[idx] = r < valid && d < D ? to_float(src[(long long)r * D + d]) : 0.0f;
  }
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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ bias, const float* __restrict__ mask, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H, int N, int D, int nW,
            int per_row, int n_ktiles) {
  __shared__ __align__(16) float sm[2 * kChunk * DP + 2 * kChunk];
  float* Qs = sm;                   // kChunk x DP
  float* Gs = Qs + kChunk * DP;     // kChunk x DP
  float* Ls = Gs + kChunk * DP;     // kChunk
  float* Ds = Ls + kChunk;          // kChunk

  long long blk = blockIdx.x;
  const int kt = (int)(blk % n_ktiles);
  blk /= n_ktiles;
  const int h = (int)(blk % H);
  blk /= H;
  const int t = (int)(blk % per_row), m = (int)(blk / per_row);  // window m + nW t, mask row m
  const long long bh = ((long long)m + (long long)nW * t) * H + h;
  const long long base = bh * N * D;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int j = kt * kRows + lane;
  const bool jv = j < N;

  float kr[DP], vr[DP], dkr[DP], dvr[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    kr[d] = jv && d < D ? to_float(k[base + (long long)j * D + d]) : 0.0f;
    vr[d] = jv && d < D ? to_float(v[base + (long long)j * D + d]) : 0.0f;
    dkr[d] = 0.0f;
    dvr[d] = 0.0f;
  }
  const float* bcol = bias + (long long)h * N * N + j;
  const float* mcol = mask != nullptr ? mask + (long long)m * N * N + j : nullptr;

  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int rows = min(kChunk, N - c0);
    __syncthreads();  // the previous chunk is consumed
    stage_rows<T, DP>(Qs, q + base + (long long)c0 * D, rows, D);
    stage_rows<T, DP>(Gs, dout + base + (long long)c0 * D, rows, D);
    if (threadIdx.x < kChunk) {
      Ls[threadIdx.x] = threadIdx.x < rows ? lse[bh * N + c0 + threadIdx.x] : 0.0f;
      Ds[threadIdx.x] = threadIdx.x < rows ? delta[bh * N + c0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    if (jv) {
      for (int r = g; r < rows; r += kGroups) {
        const float* qi = Qs + r * DP;
        const float* gi = Gs + r * DP;
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          s = fmaf(qi[d], kr[d], s);
          dp = fmaf(gi[d], vr[d], dp);
        }
        const long long off = (long long)(c0 + r) * N;
        s += mcol != nullptr ? bcol[off] + mcol[off] : bcol[off];
        const float p = expf(s - Ls[r]);
        const float pr = to_float(from_float<T>(p));  // the forward's p in the input type
        const float ds = p * (dp - Ds[r]);
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          dvr[d] = fmaf(pr, gi[d], dvr[d]);
          dkr[d] = fmaf(ds, qi[d], dkr[d]);
        }
      }
    }
  }

  // the warps' partial sums, added in warp order
  constexpr int kLd = 2 * DP + 1;
  float* red = sm;  // kRows x kLd words fit in the staging area
  __syncthreads();
  for (int gg = 0; gg < kGroups; ++gg) {
    if (g == gg) {
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        red[lane * kLd + d] = (gg ? red[lane * kLd + d] : 0.0f) + dkr[d];
        red[lane * kLd + DP + d] = (gg ? red[lane * kLd + DP + d] : 0.0f) + dvr[d];
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int jl = idx / D, d = idx - jl * D, jj = kt * kRows + jl;
    if (jj < N) {
      dk[base + (long long)jj * D + d] = from_float<T>(red[jl * kLd + d]);
      dv[base + (long long)jj * D + d] = from_float<T>(red[jl * kLd + DP + d]);
    }
  }
}

__host__ __device__ constexpr size_t dq_smem_bytes(int N, int DP) {
  return ((size_t)2 * N * kLdT + 2 * kChunk * DP + kRows * (DP + 1)) * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ bias, const float* __restrict__ mask, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dbias_part, long long B, int H,
          int N, int D, int nW, int per_row, int n_qtiles, int run) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // kChunk x DP
  float* Vs = Ks + kChunk * DP;          // kChunk x DP
  float* addT = Vs + kChunk * DP;        // N x kLdT: bias + mask of the tile's rows, key-major
  float* dbT = addT + (size_t)N * kLdT;  // N x kLdT: the run's sum of dS, key-major
  float* red = dbT + (size_t)N * kLdT;   // kRows x (DP + 1)

  long long blk = blockIdx.x;
  const int qt = (int)(blk % n_qtiles);
  blk /= n_qtiles;
  const int h = (int)(blk % H);
  const long long split = blk / H;
  const long long p0 = split * run, p1 = min(B, p0 + run);
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int i0 = qt * kRows, i = i0 + lane;
  const bool iv = i < N;

  for (int idx = threadIdx.x; idx < N * kLdT; idx += kThreads) dbT[idx] = 0.0f;
  int cur_m = -1;
  for (long long p = p0; p < p1; ++p) {  // windows in the order of their mask rows
    const int m = (int)(p / per_row), t = (int)(p % per_row);
    const long long bh = ((long long)m + (long long)nW * t) * H + h;
    const long long base = bh * N * D;
    if (m != cur_m) {
      __syncthreads();  // the previous row's addend is consumed
      const float* brows = bias + ((long long)h * N + i0) * N;
      const float* mrows = mask != nullptr ? mask + ((long long)m * N + i0) * N : nullptr;
      for (int idx = threadIdx.x; idx < kRows * N; idx += kThreads) {
        const int r = idx / N, jj = idx - r * N;
        float a = 0.0f;
        if (i0 + r < N) a = mrows != nullptr ? brows[idx] + mrows[idx] : brows[idx];
        addT[jj * kLdT + r] = a;
      }
      cur_m = m;
    }
    float qr[DP], gr[DP], dqr[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      qr[d] = iv && d < D ? to_float(q[base + (long long)i * D + d]) : 0.0f;
      gr[d] = iv && d < D ? to_float(dout[base + (long long)i * D + d]) : 0.0f;
      dqr[d] = 0.0f;
    }
    const float L = iv ? lse[bh * N + i] : 0.0f, Di = iv ? delta[bh * N + i] : 0.0f;
    for (int c0 = 0; c0 < N; c0 += kChunk) {
      const int rows = min(kChunk, N - c0);
      __syncthreads();
      stage_rows<T, DP>(Ks, k + base + (long long)c0 * D, rows, D);
      stage_rows<T, DP>(Vs, v + base + (long long)c0 * D, rows, D);
      __syncthreads();
      if (iv) {
        for (int jj = g; jj < rows; jj += kGroups) {
          const float* kj = Ks + jj * DP;
          const float* vj = Vs + jj * DP;
          float s = 0.0f, dp = 0.0f;
#pragma unroll
          for (int d = 0; d < DP; ++d) {
            s = fmaf(qr[d], kj[d], s);
            dp = fmaf(gr[d], vj[d], dp);
          }
          s += addT[(c0 + jj) * kLdT + lane];
          const float ds = expf(s - L) * (dp - Di);
#pragma unroll
          for (int d = 0; d < DP; ++d) dqr[d] = fmaf(ds, kj[d], dqr[d]);
          dbT[(c0 + jj) * kLdT + lane] += ds;
        }
      }
    }
    for (int gg = 0; gg < kGroups; ++gg) {  // dQ's partials in warp order
      if (g == gg) {
#pragma unroll
        for (int d = 0; d < DP; ++d) red[lane * (DP + 1) + d] = (gg ? red[lane * (DP + 1) + d] : 0.0f) + dqr[d];
      }
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      if (i0 + r < N) dq[base + (long long)(i0 + r) * D + d] = from_float<T>(red[r * (DP + 1) + d]);
    }
  }
  __syncthreads();
  float* part = dbias_part + ((split * H + h) * N + i0) * (long long)N;
  for (int idx = threadIdx.x; idx < kRows * N; idx += kThreads) {
    const int r = idx / N, jj = idx - r * N;
    if (i0 + r < N) part[idx] = dbT[jj * kLdT + r];
  }
}

__global__ void __launch_bounds__(kThreads)
dbias_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias, long long elems, int splits) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= elems) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[s * elems + idx];
  dbias[idx] = acc;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

int padded_d(int D) { return D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 0; }

struct Plan {
  int dp;           // the instance's head dim, D rounded up to 8, 16 or 32
  int run;          // windows a dq block walks over
  int splits;       // dbias partials (runs of windows)
  long long dq_blocks, dkdv_blocks;
  size_t dq_smem;
  int dq_per_sm;    // dq blocks an SM holds
};

template <typename T, int DP>
cudaError_t plan_dp(Plan& p, long long B, int H, int N) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p.dq_smem = dq_smem_bytes(N, DP);
  if (p.dq_smem > (size_t)optin) return cudaErrorInvalidValue;
  const auto kernel = dq_kernel<T, DP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.dq_per_sm, kernel, kThreads, p.dq_smem);
  if (err != cudaSuccess) return err;
  if (p.dq_per_sm < 1) return cudaErrorInvalidValue;
  // runs: enough dq blocks for two waves of resident blocks, at most one a window
  const long long base = cdiv(N, kRows) * H;
  const long long want = cdiv(2LL * sms * p.dq_per_sm, base);
  p.run = (int)cdiv(B, std::min(std::max(want, 1LL), B));
  p.splits = (int)cdiv(B, p.run);
  p.dq_blocks = base * p.splits;
  p.dkdv_blocks = B * H * cdiv(N, kRows);
  if (p.dq_blocks > 0x7fffffffLL || p.dkdv_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t make_plan(Plan& p, long long B, int H, int N, int D) {
  p.dp = padded_d(D);
  switch (p.dp) {
    case 8: return plan_dp<T, 8>(p, B, H, N);
    case 16: return plan_dp<T, 16>(p, B, H, N);
    case 32: return plan_dp<T, 32>(p, B, H, N);
    default: return cudaErrorInvalidValue;
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

template <typename T, int DP>
cudaError_t run_dp(const Plan& p, const void* q, const void* k, const void* v, const void* out, const void* dout,
                   const float* bias, const float* mask, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, float* dbias, float* part, long long B, int H, int N, int D, int nW,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = B * H * N;
  delta_kernel<T><<<(unsigned)cdiv(rows, kGroups), kThreads, 0, stream>>>(static_cast<const T*>(out), gt, delta,
                                                                            rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_row = (int)(B / nW), tiles = (int)cdiv(N, kRows);
  dkdv_kernel<T, DP><<<(unsigned)p.dkdv_blocks, kThreads, 0, stream>>>(
      qt, kt, vt, gt, bias, mask, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, N, D, nW, per_row, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, DP><<<(unsigned)p.dq_blocks, kThreads, p.dq_smem, stream>>>(
      qt, kt, vt, gt, bias, mask, lse, delta, static_cast<T*>(dq), p.splits > 1 ? part : dbias, B, H, N, D, nW,
      per_row, tiles, p.run);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long elems = (long long)H * N * N;
  dbias_sum_kernel<<<(unsigned)cdiv(elems, kThreads), kThreads, 0, stream>>>(part, dbias, elems, p.splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_t(const Plan& p, const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const float* bias, const float* mask, const float* lse, float* delta, void* dq, void* dk,
                  void* dv, float* dbias, float* part, long long B, int H, int N, int D, int nW,
                  cudaStream_t stream) {
  switch (p.dp) {
    case 8: return run_dp<T, 8>(p, q, k, v, out, dout, bias, mask, lse, delta, dq, dk, dv, dbias, part, B, H, N, D,
                                nW, stream);
    case 16: return run_dp<T, 16>(p, q, k, v, out, dout, bias, mask, lse, delta, dq, dk, dv, dbias, part, B, H, N,
                                  D, nW, stream);
    default: return run_dp<T, 32>(p, q, k, v, out, dout, bias, mask, lse, delta, dq, dk, dv, dbias, part, B, H, N,
                                  D, nW, stream);
  }
}

bool valid(long long B, int H, int N, int D, int nW) {
  return B > 0 && H > 0 && N > 0 && D > 0 && nW > 0 && B % nW == 0;
}

}  // namespace

// What a backward of this shape launches: info[0] the instance's head dim (8, 16 or 32),
// info[1] the windows a dq block walks over, info[2] the dbias partials (runs), info[3]
// the dq blocks, info[4] the dkdv blocks, info[5] the dq launch's dynamic shared memory in
// bytes, info[6] the dq blocks an SM holds. nW = 0 means no mask. Returns a cudaError_t:
// cudaErrorInvalidValue (1) for a shape the kernel refuses (D > 32, or N past the shared
// memory).
extern "C" int monai_window_attention_bwd_plan(long long B, int H, int N, int D, int nW, int dtype, int* info) {
  if (nW == 0) nW = 1;
  if (!valid(B, H, N, D, nW)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_for(p, B, H, N, D, dtype);
  if (err != cudaSuccess) return (int)err;
  info[0] = p.dp;
  info[1] = p.run;
  info[2] = p.splits;
  info[3] = (int)p.dq_blocks;
  info[4] = (int)p.dkdv_blocks;
  info[5] = (int)p.dq_smem;
  info[6] = p.dq_per_sm;
  return 0;
}

// The backward. delta is (B, H, N) float32 scratch; part is (splits, H, N, N) float32
// scratch where the plan has more than one split (else unused, may be null). mask may be
// null (then nW is ignored). dtype: 0 = float32, 1 = bfloat16, 2 = float16. Launches on
// `stream` and does not synchronise; returns a cudaError_t.
extern "C" int monai_window_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                          const void* mask, const void* out, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, void* dbias, void* part,
                                          long long B, int H, int N, int D, int nW, int dtype, void* stream) {
  if (mask == nullptr) nW = 1;
  if (!valid(B, H, N, D, nW)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_for(p, B, H, N, D, dtype);
  if (err != cudaSuccess) return (int)err;
  if (p.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(mask);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  auto* dbf = static_cast<float*>(dbias);
  auto* pf = static_cast<float*>(part);
  if (dtype == 0)
    err = run_t<float>(p, q, k, v, out, dout, bf, mf, lf, df, dq, dk, dv, dbf, pf, B, H, N, D, nW, s);
  else if (dtype == 1)
    err = run_t<__nv_bfloat16>(p, q, k, v, out, dout, bf, mf, lf, df, dq, dk, dv, dbf, pf, B, H, N, D, nW, s);
  else
    err = run_t<__half>(p, q, k, v, out, dout, bf, mf, lf, df, dq, dk, dv, dbf, pf, B, H, N, D, nW, s);
  return (int)err;
}
