// Instance norm with an optional affine and an optional (leaky or parametric) ReLU,
// forward, on channels-last memory:
//
//   m = sum(x) / S,  v = max(sum(x^2) / S - m^2, 0)         per (instance, channel), f32
//   y = (x - m) rsqrt(v + eps) w + b,  then  y = y >= 0 ? y : a y
//
// x and y are contiguous (B, S, C), float32, bfloat16 or float16 (S the voxels of one
// instance); w, b and a (one value or one per channel) are optional, each float32,
// bfloat16 or float16; y is in x's type.
//
// Replaces monai_tpu/networks/layers/fast_norm.py::_in_norm, the JAX package's
// hand-written instance norm (two-moment f32 statistics, then the affine), with the
// PReLU that the networks apply next fused in.
//
// What bounds it on the card: the bytes. It does ~10 operations an element, so one read
// of x and one write of y at 3.35 TB/s is the least it can take: 1.04 ms for the 26
// norms of a 6-window SwinUNETR forward in bfloat16, 0.24 ms for the 17 of an 18-window
// UNet forward. Six (6, 96^3, 24) sites carry 88% of Swin's bytes.
//
// The design. The host plans every launch (monai_tpu_torch/networks/layers/fast_norm.py,
// instance_norm_plan): a unit is one instance's slab of G channels (G = C but where a
// slab is cut into channel groups), read as vectors of V elements.
//
// - Vectors. A thread moves 16 bytes at a time (V = 8 bfloat16 or float16, 4 float32).
//   Where V divides G, a unit row of G channels is G / V vectors (its phases); a block
//   has a multiple of that many threads and strides over the unit by a multiple of it,
//   so every vector a thread touches holds the same V channels: the thread keeps one f32
//   sum and one sum of squares per lane, with no padded lanes at C = 24. Where V is a
//   multiple of C (C = 1, 2, 4: a vector holds V / C voxels) every thread has one phase
//   and lane j holds channel j % C. Any other C, or an x whose data pointer is not 16-byte
//   aligned, takes V = 1 (the general path: right, not fast).
// - Partials combine in a fixed order, never by floating-point atomics: a block's lanes
//   through shared memory, then the blocks of a unit in block order. Every block of a
//   unit computes the statistics itself, in the same order, so the output is the same
//   bits from run to run.
// - On chip (norm_onchip): where a unit's slab fits a block's shared memory, one block a
//   unit loads it once by cp.async, 16 bytes a copy and all in flight, reduces it, then
//   normalises from shared memory and writes once. Its traffic is exactly the bound.
// - Persistent (norm_persistent): one cooperative launch of as many blocks as the card
//   holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), so a grid-wide
//   barrier cannot deadlock. For each group of units the blocks of a unit write their
//   partial sums to an f32 scratch, meet at the barrier, combine the partials and
//   normalise. A thread keeps its first vectors of the sums pass in shared memory (the
//   stash: what a block may take without lowering its occupancy, ~24 MB over the card),
//   and the normalize pass walks the rest in the reverse order of the sums, so that what
//   L2 still holds is read first; the units go in groups that the stash and an L2 budget
//   hold together (one 42.5 MB instance a group at SwinUNETR's widest site). The output
//   is written with streaming stores, which keep L2 for x. One launch a site.
//
// Left for later: thread-block clusters with distributed shared memory, which would take
// the single on-chip pass to slabs up to ~1.5 MB.
//
// The backward (norm_bwd_onchip, norm_bwd_persistent), for training. Replaces
// monai_tpu/networks/layers/fast_norm.py::_in_norm_bwd, with the PReLU's backward fused
// in. With the forward's saved per-(instance, channel) mean m and r = rsqrt(var + eps)
// (the forward writes them where it is asked to), x^ = (x - m) r, z = x^ w + b the value
// before the slope and gz = g (z >= 0 ? 1 : a), over the S voxels of an instance:
//
//   sums:  Sg = sum(gz),  Sgx = sum(gz x^),  Sa = sum(g z [z < 0])
//   dx  =  w r (gz - Sg / S - x^ Sgx / S)
//
// and the host takes db = sum_B Sg, dw = sum_B Sgx and da = sum_B Sa (over the channels
// too for one slope). It saves x and the statistics, not the output: with w = 0 the
// output holds no x^ (JAX's y-based form divides by w there).
//
// What bounds it on the card: the bytes, three passes (x and g read once, dx written once)
// at 3.35 TB/s: 4.15 ms for the 26 norms of a float32 SwinUNETR step at batch 4 of 96^3,
// 88% of it at six (4, 48, 96^3) sites, where one instance's x and g (340 MB) are 6.8
// times the 50 MB L2. dx needs the sums over the whole instance, so x and g are read a
// second time unless they stay on chip from the sums to dx. The design, one launch a site
// (the host plans it: fast_norm.py, instance_norm_backward_plan):
// - On chip (norm_bwd_onchip): where a unit's x and g slabs both fit a block's shared
//   memory, one block a unit copies both in once by cp.async, sums, then writes dx from
//   there: exactly the three passes.
// - Persistent (norm_bwd_persistent): elsewhere one cooperative launch of as many blocks as
//   the card holds, the forward's design holding both x and g. For each group of units the
//   blocks of a unit run the sums pass, each thread keeping its first vectors of x and of g
//   in a shared-memory stash; they write float32 partials, meet at the grid barrier and
//   fold their unit's partials in block order; then they write dx, first the vectors
//   outside the stash in the reverse of the sums' order (what L2 still holds), then the
//   stash, with streaming stores that leave L2 to x and g. The plan takes as a unit the
//   widest channel group whose x and g the stash (~28 MB over the card) and an L2 budget
//   (24 MB) hold, of the groups whose rows span a 128-byte line; else the narrowest such
//   group: narrower rows read at 41-80% of the rate of whole rows, which costs more than
//   reading x and g twice. At (4, 48, 96^3) no group fits, a unit is a whole 340 MB
//   instance and ~85% of it is read twice (~4.7 passes); from (4, 48, 48^3) down a unit's
//   x and g stay on chip, and the kernel moves the three passes.
// z >= 0 takes the positive branch, as in the forward; z is rounded after its product and
// its sum, as the plain version rounds it. Partials combine in a fixed order, never by
// atomics, so dx and the sums are the same bits from run to run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;  // the persistent sums pass's 16-byte loads in flight a thread (6 and 8: no faster)

struct NormArgs {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  const void* a;
  int w_type, b_type, a_type;  // 0 float32, 1 bfloat16, 2 float16
  int a_n;                     // the slope: 0 none, 1 one value, C one per channel
  unsigned* bar;               // persistent: the grid barrier's arrival count and generation
  float* partial;              // persistent: [units][per_unit][G] sums, then the same of squares
  long long S;                 // voxels an instance
  int C, G, groups;            // channels, channels a unit, units an instance
  int gv;                      // phases a unit row: G / V, or 1 where a vector holds V / C voxels
  long long rowstride;         // elements from one unit row to the next
  long long nvec;              // vectors a unit
  int units;                   // B * groups
  int per_unit;                // persistent: blocks a unit
  int units_per_group;         // persistent: units that share the grid at once
  int unit_groups;             // persistent: groups of units, walked in turn
  int stash;                   // persistent: a thread's first vectors kept in shared memory
  float* stats;                // optional: [2][B][C] float32, the mean, then rsqrt(var + eps)
  long long stat_stride;       // B * C
  float inv_n, eps;
};

__device__ __forceinline__ float param(const void* p, int type, int i) {
  if (type == 0) return static_cast<const float*>(p)[i];
  if (type == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

// A 16-byte vector of T as V float32 values.
template <typename T, int V>
__device__ __forceinline__ void to_floats(const uint4& u, float (&f)[V]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      __half2 h;
      *reinterpret_cast<unsigned*>(&h) = w[i];
      const float2 g = __half22float2(h);
      f[2 * i] = g.x;
      f[2 * i + 1] = g.y;
    }
  }
}

// V elements of x at p as float32: one 16-byte load where V * sizeof(T) == 16.
template <typename T, int V>
__device__ __forceinline__ void load_f(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) f[0] = *reinterpret_cast<const float*>(p);
    else if constexpr (std::is_same<T, __nv_bfloat16>::value) f[0] = __bfloat162float(*p);
    else f[0] = __half2float(*p);
  } else {
    to_floats<T, V>(*reinterpret_cast<const uint4*>(p), f);
  }
}

// V float32 values rounded to T (to nearest) and stored at p; 16-byte stores stream
// past L2 (st.global.cs).
template <typename T, int V>
__device__ __forceinline__ void store_f(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) *reinterpret_cast<float*>(p) = f[0];
    else if constexpr (std::is_same<T, __nv_bfloat16>::value) *p = __float2bfloat16_rn(f[0]);
    else *p = __float2half_rn(f[0]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&h);
      } else {
        const __half2 h = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&h);
      }
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// The block's shared memory past the on-chip slab, in floats: the lanes' sums and sums
// of squares (2 T V), the sub-sums of the fold (2 max(T, G)), the totals (2 G) and the
// per-channel mean, scale, shift and slope (4 G). The host sizes it the same way.
struct Scratch {
  float *lane_a, *lane_b, *sub_a, *sub_b, *tot_a, *tot_b, *mean, *scale, *shift, *slope;
  __device__ Scratch(float* s, int T, int V, int G) {
    const int subn = T > G ? T : G;
    lane_a = s;
    lane_b = lane_a + T * V;
    sub_a = lane_b + T * V;
    sub_b = sub_a + subn;
    tot_a = sub_b + subn;
    tot_b = tot_a + G;
    mean = tot_b + G;
    scale = mean + G;
    shift = scale + G;
    slope = shift + G;
  }
};

__host__ __device__ constexpr int scratch_floats(int T, int V, int G) {
  return 2 * T * V + 2 * (T > G ? T : G) + 6 * G;
}

// Sums n values a channel into tot_a / tot_b, in a fixed order: get(i, c) returns the
// i-th (sum, sum of squares) pair of channel c. Threads split the n values of a channel
// into nsub strided runs, then one thread adds the runs in order. All threads call it.
template <typename Get>
__device__ __forceinline__ void fold(const Scratch& s, int G, int n, Get get) {
  const int T = blockDim.x, t = threadIdx.x;
  const int nsub = T >= G ? T / G : 1;
  for (int idx = t; idx < G * nsub; idx += T) {
    const int c = idx % G, sl = idx / G;
    float sa = 0.f, sb = 0.f;
    int i = sl;
    // eight values in flight at a time (the partials come from L2), added in order
    for (; i + 7 * nsub < n; i += 8 * nsub) {
      float2 v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) v[m] = get(i + m * nsub, c);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        sa += v[m].x;
        sb += v[m].y;
      }
    }
    for (; i < n; i += nsub) {
      const float2 v = get(i, c);
      sa += v.x;
      sb += v.y;
    }
    s.sub_a[sl * G + c] = sa;
    s.sub_b[sl * G + c] = sb;
  }
  __syncthreads();
  for (int c = t; c < G; c += T) {
    float sa = 0.f, sb = 0.f;
    for (int sl = 0; sl < nsub; ++sl) {
      sa += s.sub_a[sl * G + c];
      sb += s.sub_b[sl * G + c];
    }
    s.tot_a[c] = sa;
    s.tot_b[c] = sb;
  }
  __syncthreads();
}

// The block's per-lane sums folded per channel into tot_a / tot_b. Thread t = r gv + k
// holds phase k; its lane j is element q = k V + j of a W = gv V element row, channel
// q % G, so channel c gathers lane_[r W + q] over r and over q = c, c + G, ... < W.
template <int V>
__device__ __forceinline__ void fold_lanes(const Scratch& s, const float (&acc)[V], const float (&acc2)[V], int G,
                                           int gv) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s.lane_a[t * V + j] = acc[j];
    s.lane_b[t * V + j] = acc2[j];
  }
  __syncthreads();
  const int W = gv * V, R = blockDim.x / gv;
  // a row r's pairs for channel c: the W / G (or one) elements q = c + mG of the row
  const int per_row = W / G > 0 ? W / G : 1;
  fold(s, G, R * per_row, [&](int i, int c) {
    const int r = i / per_row, q = c + (i % per_row) * G;
    return make_float2(s.lane_a[r * W + q], s.lane_b[r * W + q]);
  });
}

// mean, scale, shift and slope of the unit's G channels (channel offset c0), from the
// totals; then each lane's four into registers. stats, where not null, is the unit's
// place in a.stats (instance bi: bi C + c0), and gets the mean and rsqrt(var + eps).
template <int V>
__device__ __forceinline__ void lane_stats(const Scratch& s, const NormArgs& a, int c0, int k, float (&mean)[V],
                                           float (&scale)[V], float (&shift)[V], float (&slope)[V],
                                           float* stats) {
  for (int c = threadIdx.x; c < a.G; c += blockDim.x) {
    const float m = s.tot_a[c] * a.inv_n;
    const float var = fmaxf(s.tot_b[c] * a.inv_n - m * m, 0.f);
    const float r = rsqrtf(var + a.eps);
    if (stats != nullptr) {
      stats[c] = m;
      stats[a.stat_stride + c] = r;
    }
    float sc = r;
    if (a.w != nullptr) sc *= param(a.w, a.w_type, c0 + c);
    s.mean[c] = m;
    s.scale[c] = sc;
    s.shift[c] = a.b != nullptr ? param(a.b, a.b_type, c0 + c) : 0.f;
    s.slope[c] = a.a_n == 0 ? 0.f : param(a.a, a.a_type, a.a_n == 1 ? 0 : c0 + c);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (k * V + j) % a.G;
    mean[j] = s.mean[c];
    scale[j] = s.scale[c];
    shift[j] = s.shift[c];
    slope[j] = s.slope[c];
  }
}

template <int V>
__device__ __forceinline__ void normalize(float (&f)[V], const float (&mean)[V], const float (&scale)[V],
                                          const float (&shift)[V], const float (&slope)[V], bool has_slope) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float y = (f[j] - mean[j]) * scale[j] + shift[j];
    f[j] = has_slope && y < 0.f ? y * slope[j] : y;
  }
}

template <int V>
__device__ __forceinline__ void accumulate(const float (&f)[V], float (&acc)[V], float (&acc2)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc[j] += f[j];
    acc2[j] = fmaf(f[j], f[j], acc2[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// One block a unit: the slab into shared memory once, then the statistics and the
// normalised output from there.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads) norm_onchip(NormArgs a) {
  extern __shared__ float4 smem4[];
  T* slab = reinterpret_cast<T*>(smem4);
  const Scratch s(reinterpret_cast<float*>(smem4) + a.nvec * 4, blockDim.x, V, a.G);
  const int t = threadIdx.x, T_ = blockDim.x;
  const int u = blockIdx.x, bi = u / a.groups, g = u % a.groups;
  const long long base = (long long)bi * a.S * a.C + (long long)g * a.G;
  const T* x = static_cast<const T*>(a.x) + base;
  T* y = static_cast<T*>(a.y) + base;
  const int k = t % a.gv, rows = T_ / a.gv;
  // vector i = row gv + k of the unit lands at slab[i V]
  for (long long i = t, row = t / a.gv; i < a.nvec; i += T_, row += rows)
    cp_async16(slab + i * V, x + row * a.rowstride + k * V);
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::);
  __syncthreads();

  float acc[V], acc2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
  for (long long i = t; i < a.nvec; i += T_) {
    float f[V];
    load_f<T, V>(slab + i * V, f);
    accumulate(f, acc, acc2);
  }
  fold_lanes<V>(s, acc, acc2, a.G, a.gv);
  float mean[V], scale[V], shift[V], slope[V];
  lane_stats<V>(s, a, g * a.G, k, mean, scale, shift, slope,
                a.stats != nullptr ? a.stats + (long long)bi * a.C + g * a.G : nullptr);
  const bool has_slope = a.a_n != 0;
  for (long long i = t, row = t / a.gv; i < a.nvec; i += T_, row += rows) {
    float f[V];
    load_f<T, V>(slab + i * V, f);
    normalize(f, mean, scale, shift, slope, has_slope);
    store_f<T, V>(y + row * a.rowstride + k * V, f);
  }
}

// Every block arrives, the last one opens the next generation; co-residency of the grid
// is guaranteed by the cooperative launch. bar[0] counts arrivals and is back at 0 after
// each barrier; bar[1] is the generation.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The whole card in one launch: per_unit blocks a unit, units_per_group units at once.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 2) norm_persistent(NormArgs a) {
  extern __shared__ float4 smem4[];
  const Scratch s(reinterpret_cast<float*>(smem4), blockDim.x, V, a.G);
  const int t = threadIdx.x, T_ = blockDim.x;
  const int P = a.per_unit, jb = blockIdx.x % P, slot = blockIdx.x / P;
  const int k = t % a.gv;
  const long long stride = (long long)P * T_;         // vectors from one step to the next
  const long long step = stride / a.gv * a.rowstride;  // elements from one step to the next
  const long long i0 = (long long)jb * T_ + t;
  const long long n_it = i0 < a.nvec ? (a.nvec - 1 - i0) / stride + 1 : 0;
  const long long off0 = i0 / a.gv * a.rowstride + k * V;
  // the stash, past the scratch: a thread's vector it at [it T + t]; each thread reads
  // back only what it wrote
  uint4* stash = reinterpret_cast<uint4*>(smem4) + (scratch_floats(T_, V, a.G) + 3) / 4;
  const long long n_st = n_it < a.stash ? n_it : a.stash;
  float* part_a = a.partial;
  float* part_b = a.partial + (long long)a.units * P * a.G;
  const bool has_slope = a.a_n != 0;

  for (int ug = 0; ug < a.unit_groups; ++ug) {
    const int u = ug * a.units_per_group + slot;
    const bool active = u < a.units;  // the same for the whole block
    const int bi = u / a.groups, g = u % a.groups;
    const long long base = (long long)bi * a.S * a.C + (long long)g * a.G;
    const T* x = static_cast<const T*>(a.x) + base + off0;
    T* y = static_cast<T*>(a.y) + base + off0;

    float acc[V], acc2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
    if (active) {
      long long it = 0;
      if constexpr (V > 1) {  // kUnroll 16-byte loads in flight; the first n_st also go to the stash
        for (; it + kUnroll <= n_it; it += kUnroll) {
          uint4 r[kUnroll];
#pragma unroll
          for (int m = 0; m < kUnroll; ++m) r[m] = *reinterpret_cast<const uint4*>(x + (it + m) * step);
#pragma unroll
          for (int m = 0; m < kUnroll; ++m) {
            if (it + m < n_st) stash[(it + m) * T_ + t] = r[m];
            float f[V];
            to_floats<T, V>(r[m], f);
            accumulate(f, acc, acc2);
          }
        }
      } else {
        for (; it + 4 <= n_it; it += 4) {
          float f0[V], f1[V], f2[V], f3[V];
          load_f<T, V>(x + it * step, f0);
          load_f<T, V>(x + (it + 1) * step, f1);
          load_f<T, V>(x + (it + 2) * step, f2);
          load_f<T, V>(x + (it + 3) * step, f3);
          accumulate(f0, acc, acc2);
          accumulate(f1, acc, acc2);
          accumulate(f2, acc, acc2);
          accumulate(f3, acc, acc2);
        }
      }
      for (; it < n_it; ++it) {
        float f[V];
        load_f<T, V>(x + it * step, f);
        if constexpr (V > 1) {
          if (it < n_st) stash[it * T_ + t] = *reinterpret_cast<const uint4*>(x + it * step);
        }
        accumulate(f, acc, acc2);
      }
    }
    fold_lanes<V>(s, acc, acc2, a.G, a.gv);
    if (active) {
      const long long out = ((long long)u * P + jb) * a.G;
      for (int c = t; c < a.G; c += T_) {
        part_a[out + c] = s.tot_a[c];
        part_b[out + c] = s.tot_b[c];
      }
    }
    grid_barrier(a.bar);
    if (active) {
      const long long in = (long long)u * P * a.G;
      fold(s, a.G, P, [&](int p, int c) {
        return make_float2(__ldcg(part_a + in + (long long)p * a.G + c), __ldcg(part_b + in + (long long)p * a.G + c));
      });
      float mean[V], scale[V], shift[V], slope[V];
      lane_stats<V>(s, a, g * a.G, k, mean, scale, shift, slope,
                    a.stats != nullptr && jb == 0 ? a.stats + (long long)bi * a.C + g * a.G : nullptr);
      // the reverse of the statistics pass: its last vectors are the likeliest in L2,
      // and its first ones are in the stash
      long long it = n_it;
      for (; it >= n_st + 4; it -= 4) {
        float f0[V], f1[V], f2[V], f3[V];
        load_f<T, V>(x + (it - 1) * step, f0);
        load_f<T, V>(x + (it - 2) * step, f1);
        load_f<T, V>(x + (it - 3) * step, f2);
        load_f<T, V>(x + (it - 4) * step, f3);
        normalize(f0, mean, scale, shift, slope, has_slope);
        normalize(f1, mean, scale, shift, slope, has_slope);
        normalize(f2, mean, scale, shift, slope, has_slope);
        normalize(f3, mean, scale, shift, slope, has_slope);
        store_f<T, V>(y + (it - 1) * step, f0);
        store_f<T, V>(y + (it - 2) * step, f1);
        store_f<T, V>(y + (it - 3) * step, f2);
        store_f<T, V>(y + (it - 4) * step, f3);
      }
      for (; it > n_st; --it) {
        float f[V];
        load_f<T, V>(x + (it - 1) * step, f);
        normalize(f, mean, scale, shift, slope, has_slope);
        store_f<T, V>(y + (it - 1) * step, f);
      }
      if constexpr (V > 1) {
#pragma unroll 4
        for (; it > 0; --it) {
          float f[V];
          to_floats<T, V>(stash[(it - 1) * T_ + t], f);
          normalize(f, mean, scale, shift, slope, has_slope);
          store_f<T, V>(y + (it - 1) * step, f);
        }
      }
    }
    __syncthreads();  // the scratch is reused by the next group
  }
}

// ---- the backward ----

constexpr int kBwdUnroll = 4;  // the backward's vectors of x and of g in flight a thread (8: no faster)

struct BwdArgs {
  const void* x;
  const void* g;
  void* dx;
  const float* stats;  // [2][B][C]: the forward's mean and rsqrt(var + eps)
  const void* w;
  const void* b;
  const void* a;
  int w_type, b_type, a_type, a_n;
  unsigned* bar;             // persistent: the grid barrier's arrival count and generation
  float* partial;            // persistent: [3][units][per_unit][G]
  float* sums;               // [3][B][C]: sum(gz), sum(gz x^), sum(g z [z < 0])
  long long S, stat_stride;  // stat_stride = B C
  int C, G, groups, gv;
  long long rowstride, nvec;
  int units, per_unit, units_per_group, unit_groups;
  int stash;  // persistent: a thread's first vectors of x and of g kept in shared memory
  float inv_n;
};

// The backward block's shared memory past the on-chip slabs, in floats: the lanes' three
// sums (3 T V), the sub-sums of the fold (3 max(T, G)), the three totals (3 G) and the
// per-channel mean, rsqrt(var + eps), scale, shift and slope (5 G). The host sizes it the
// same way (fast_norm.py _bwd_smem_floats).
struct BwdScratch {
  float *lane, *sub, *tot, *mean, *rstd, *scale, *shift, *slope;
  int tv, m;
  __device__ BwdScratch(float* s, int T, int V, int G) : tv(T * V), m(T > G ? T : G) {
    lane = s;
    sub = lane + 3 * tv;
    tot = sub + 3 * m;
    mean = tot + 3 * G;
    rstd = mean + G;
    scale = rstd + G;
    shift = scale + G;
    slope = shift + G;
  }
};

__host__ __device__ constexpr int bwd_scratch_floats(int T, int V, int G) {
  return 3 * T * V + 3 * (T > G ? T : G) + 8 * G;
}

// fold's order for three sums a channel, into tot[0, G), [G, 2G) and [2G, 3G): get(i, c)
// returns the i-th triple of channel c. All threads call it.
template <typename Get>
__device__ __forceinline__ void fold3(const BwdScratch& s, int G, int n, Get get) {
  const int T = blockDim.x, t = threadIdx.x;
  const int nsub = T >= G ? T / G : 1;
  for (int idx = t; idx < G * nsub; idx += T) {  // idx = sl G + c
    const int c = idx % G, sl = idx / G;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    int i = sl;
    for (; i + 7 * nsub < n; i += 8 * nsub) {  // eight triples in flight, added in order
      float3 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = get(i + q * nsub, c);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s0 += v[q].x;
        s1 += v[q].y;
        s2 += v[q].z;
      }
    }
    for (; i < n; i += nsub) {
      const float3 v = get(i, c);
      s0 += v.x;
      s1 += v.y;
      s2 += v.z;
    }
    s.sub[idx] = s0;
    s.sub[s.m + idx] = s1;
    s.sub[2 * s.m + idx] = s2;
  }
  __syncthreads();
  for (int c = t; c < G; c += T) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int sl = 0; sl < nsub; ++sl) {
      s0 += s.sub[sl * G + c];
      s1 += s.sub[s.m + sl * G + c];
      s2 += s.sub[2 * s.m + sl * G + c];
    }
    s.tot[c] = s0;
    s.tot[G + c] = s1;
    s.tot[2 * G + c] = s2;
  }
  __syncthreads();
}

// The block's three per-lane sums folded per channel, as fold_lanes folds two.
template <int V>
__device__ __forceinline__ void fold3_lanes(const BwdScratch& s, const float (&a0)[V], const float (&a1)[V],
                                            const float (&a2)[V], int G, int gv) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s.lane[t * V + j] = a0[j];
    s.lane[s.tv + t * V + j] = a1[j];
    s.lane[2 * s.tv + t * V + j] = a2[j];
  }
  __syncthreads();
  const int W = gv * V, R = blockDim.x / gv;
  const int per_row = W / G > 0 ? W / G : 1;
  fold3(s, G, R * per_row, [&](int i, int c) {
    const int o = (i / per_row) * W + c + (i % per_row) * G;
    return make_float3(s.lane[o], s.lane[s.tv + o], s.lane[2 * s.tv + o]);
  });
}

// A lane's statistics and parameters.
template <int V>
struct Lanes {
  float mean[V], rstd[V], scale[V], shift[V], slope[V];
};

// The unit's per-channel statistics and parameters (instance bi, channel offset c0) into
// shared memory, then those of lane j of phase k into p. All threads call it.
template <int V>
__device__ __forceinline__ void bwd_lanes(const BwdScratch& s, const BwdArgs& a, int bi, int c0, int k, Lanes<V>& p) {
  const float* st = a.stats + (long long)bi * a.C + c0;
  for (int c = threadIdx.x; c < a.G; c += blockDim.x) {
    const float r = st[a.stat_stride + c];
    float sc = r;  // the forward's scale, by the same operations
    if (a.w != nullptr) sc *= param(a.w, a.w_type, c0 + c);
    s.mean[c] = st[c];
    s.rstd[c] = r;
    s.scale[c] = sc;
    s.shift[c] = a.b != nullptr ? param(a.b, a.b_type, c0 + c) : 0.f;
    s.slope[c] = a.a_n == 0 ? 1.f : param(a.a, a.a_type, a.a_n == 1 ? 0 : c0 + c);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (k * V + j) % a.G;
    p.mean[j] = s.mean[c];
    p.rstd[j] = s.rstd[c];
    p.scale[j] = s.scale[c];
    p.shift[j] = s.shift[c];
    p.slope[j] = s.slope[c];
  }
}

// z, rounded after the product and after the sum (no fused multiply-add), as the plain
// version rounds it, so that both take the same branch of the slope given one x and one
// set of statistics.
__device__ __forceinline__ float z_of(float x, float mean, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x - mean, scale), shift);
}

template <int V>
__device__ __forceinline__ void bwd_accumulate(const float (&xf)[V], const float (&gf)[V], const Lanes<V>& p,
                                               bool has_slope, float (&s1)[V], float (&s2)[V], float (&s3)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xh = (xf[j] - p.mean[j]) * p.rstd[j];
    const float z = z_of(xf[j], p.mean[j], p.scale[j], p.shift[j]);
    const bool neg = has_slope && z < 0.f;
    const float gz = neg ? gf[j] * p.slope[j] : gf[j];
    s1[j] += gz;
    s2[j] = fmaf(gz, xh, s2[j]);
    if (neg) s3[j] = fmaf(gf[j], z, s3[j]);
  }
}

// dx into xf; mg and mgx are the lane's Sg / S and Sgx / S.
template <int V>
__device__ __forceinline__ void bwd_dx(float (&xf)[V], const float (&gf)[V], const Lanes<V>& p, bool has_slope,
                                       const float (&mg)[V], const float (&mgx)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xh = (xf[j] - p.mean[j]) * p.rstd[j];
    const float z = z_of(xf[j], p.mean[j], p.scale[j], p.shift[j]);
    const float gz = has_slope && z < 0.f ? gf[j] * p.slope[j] : gf[j];
    xf[j] = p.scale[j] * (gz - mg[j] - xh * mgx[j]);
  }
}

// The unit's sums from the totals: written to a.sums where `write`, and Sg / S and Sgx / S
// of each lane.
template <int V>
__device__ __forceinline__ void bwd_means(const BwdScratch& s, const BwdArgs& a, int bi, int c0, int k, bool write,
                                          float (&mg)[V], float (&mgx)[V]) {
  if (write) {
    float* so = a.sums + (long long)bi * a.C + c0;
    for (int c = threadIdx.x; c < a.G; c += blockDim.x) {
      so[c] = s.tot[c];
      so[a.stat_stride + c] = s.tot[a.G + c];
      so[2 * a.stat_stride + c] = s.tot[2 * a.G + c];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (k * V + j) % a.G;
    mg[j] = s.tot[c] * a.inv_n;
    mgx[j] = s.tot[a.G + c] * a.inv_n;
  }
}

// A vector as it is loaded: 16 bytes, or one element on the general path.
template <typename T, int V>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load_raw(const T* p) {
  if constexpr (V == 1) return *p;
  else return *reinterpret_cast<const uint4*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void raw_floats(const typename Raw<T, V>::type& r, float (&f)[V]) {
  if constexpr (V == 1) load_f<T, 1>(&r, f);
  else to_floats<T, V>(r, f);
}

// One block a unit: x's and g's slabs into shared memory once, then the sums and dx from
// there.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads) norm_bwd_onchip(BwdArgs a) {
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  T* gs = xs + a.nvec * V;
  const int t = threadIdx.x, T_ = blockDim.x;
  const BwdScratch s(reinterpret_cast<float*>(gs + a.nvec * V), T_, V, a.G);
  const int u = blockIdx.x, bi = u / a.groups, c0 = (u % a.groups) * a.G;
  const long long base = (long long)bi * a.S * a.C + c0;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* gp = static_cast<const T*>(a.g) + base;
  T* dx = static_cast<T*>(a.dx) + base;
  const int k = t % a.gv, rows = T_ / a.gv;
  // vector i = row gv + k of the unit lands at xs[i V] and gs[i V]; each thread reads back
  // only the vectors it copied
  for (long long i = t, row = t / a.gv; i < a.nvec; i += T_, row += rows) {
    cp_async16(xs + i * V, x + row * a.rowstride + k * V);
    cp_async16(gs + i * V, gp + row * a.rowstride + k * V);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  Lanes<V> p;
  bwd_lanes<V>(s, a, bi, c0, k, p);  // while the copies are in flight
  asm volatile("cp.async.wait_all;\n" ::);
  const bool has_slope = a.a_n != 0;
  float s1[V], s2[V], s3[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = s3[j] = 0.f;
  for (long long i = t; i < a.nvec; i += T_) {
    float xf[V], gf[V];
    load_f<T, V>(xs + i * V, xf);
    load_f<T, V>(gs + i * V, gf);
    bwd_accumulate(xf, gf, p, has_slope, s1, s2, s3);
  }
  fold3_lanes<V>(s, s1, s2, s3, a.G, a.gv);
  float mg[V], mgx[V];
  bwd_means<V>(s, a, bi, c0, k, true, mg, mgx);
  for (long long i = t, row = t / a.gv; i < a.nvec; i += T_, row += rows) {
    float xf[V], gf[V];
    load_f<T, V>(xs + i * V, xf);
    load_f<T, V>(gs + i * V, gf);
    bwd_dx(xf, gf, p, has_slope, mg, mgx);
    store_f<T, V>(dx + row * a.rowstride + k * V, xf);
  }
}

// The whole card in one cooperative launch: per_unit blocks a unit, units_per_group units
// at once, the groups in turn; a grid barrier between each group's sums and its dx. One
// block an SM (160-187 registers a thread; capped at 128 for two, it spilled and ran slower).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 1) norm_bwd_persistent(BwdArgs a) {
  using R = typename Raw<T, V>::type;
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x, T_ = blockDim.x;
  const BwdScratch s(reinterpret_cast<float*>(smem4), T_, V, a.G);
  // the stash, past the scratch: a thread's vector it of x at [2 it T + t], of g at
  // [(2 it + 1) T + t]; each thread reads back only what it wrote
  uint4* stash = reinterpret_cast<uint4*>(smem4) + (bwd_scratch_floats(T_, V, a.G) + 3) / 4;
  const int P = a.per_unit, jb = blockIdx.x % P, slot = blockIdx.x / P;
  const int k = t % a.gv;
  const long long stride = (long long)P * T_;         // vectors from one step to the next
  const long long step = stride / a.gv * a.rowstride;  // elements from one step to the next
  const long long i0 = (long long)jb * T_ + t;
  const long long n_it = i0 < a.nvec ? (a.nvec - 1 - i0) / stride + 1 : 0;
  const long long off0 = i0 / a.gv * a.rowstride + k * V;
  const long long n_st = V > 1 ? (n_it < a.stash ? n_it : a.stash) : 0;
  const long long plane = (long long)a.units * P * a.G;
  const bool has_slope = a.a_n != 0;

  for (int ug = 0; ug < a.unit_groups; ++ug) {
    const int u = ug * a.units_per_group + slot;
    const bool active = u < a.units;  // the same for the whole block
    const int bi = active ? u / a.groups : 0, c0 = active ? (u % a.groups) * a.G : 0;
    const long long base = (long long)bi * a.S * a.C + c0 + off0;
    const T* x = static_cast<const T*>(a.x) + base;
    const T* gp = static_cast<const T*>(a.g) + base;
    T* dx = static_cast<T*>(a.dx) + base;
    Lanes<V> p;
    bwd_lanes<V>(s, a, bi, c0, k, p);
    float s1[V], s2[V], s3[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = s3[j] = 0.f;
    if (active) {
      long long it = 0;
      for (; it + kBwdUnroll <= n_it; it += kBwdUnroll) {
        R rx[kBwdUnroll], rg[kBwdUnroll];
#pragma unroll
        for (int q = 0; q < kBwdUnroll; ++q) {
          rx[q] = load_raw<T, V>(x + (it + q) * step);
          rg[q] = load_raw<T, V>(gp + (it + q) * step);
        }
#pragma unroll
        for (int q = 0; q < kBwdUnroll; ++q) {
          if constexpr (V > 1) {
            if (it + q < n_st) {
              stash[2 * (it + q) * T_ + t] = rx[q];
              stash[(2 * (it + q) + 1) * T_ + t] = rg[q];
            }
          }
          float xf[V], gf[V];
          raw_floats<T, V>(rx[q], xf);
          raw_floats<T, V>(rg[q], gf);
          bwd_accumulate(xf, gf, p, has_slope, s1, s2, s3);
        }
      }
      for (; it < n_it; ++it) {
        const R rx = load_raw<T, V>(x + it * step), rg = load_raw<T, V>(gp + it * step);
        if constexpr (V > 1) {
          if (it < n_st) {
            stash[2 * it * T_ + t] = rx;
            stash[(2 * it + 1) * T_ + t] = rg;
          }
        }
        float xf[V], gf[V];
        raw_floats<T, V>(rx, xf);
        raw_floats<T, V>(rg, gf);
        bwd_accumulate(xf, gf, p, has_slope, s1, s2, s3);
      }
    }
    fold3_lanes<V>(s, s1, s2, s3, a.G, a.gv);
    if (active) {
      const long long out = ((long long)u * P + jb) * a.G;
      for (int c = t; c < a.G; c += T_) {
        a.partial[out + c] = s.tot[c];
        a.partial[plane + out + c] = s.tot[a.G + c];
        a.partial[2 * plane + out + c] = s.tot[2 * a.G + c];
      }
    }
    grid_barrier(a.bar);
    if (active) {
      const float* in = a.partial + (long long)u * P * a.G;
      fold3(s, a.G, P, [&](int q, int c) {
        const long long o = (long long)q * a.G + c;
        return make_float3(__ldcg(in + o), __ldcg(in + plane + o), __ldcg(in + 2 * plane + o));
      });
      float mg[V], mgx[V];
      bwd_means<V>(s, a, bi, c0, k, jb == 0, mg, mgx);
      // the reverse of the sums pass: its last vectors are the likeliest in L2, and its
      // first ones are in the stash
      long long it = n_it;
      for (; it >= n_st + kBwdUnroll; it -= kBwdUnroll) {
        R rx[kBwdUnroll], rg[kBwdUnroll];
#pragma unroll
        for (int q = 0; q < kBwdUnroll; ++q) {
          rx[q] = load_raw<T, V>(x + (it - 1 - q) * step);
          rg[q] = load_raw<T, V>(gp + (it - 1 - q) * step);
        }
#pragma unroll
        for (int q = 0; q < kBwdUnroll; ++q) {
          float xf[V], gf[V];
          raw_floats<T, V>(rx[q], xf);
          raw_floats<T, V>(rg[q], gf);
          bwd_dx(xf, gf, p, has_slope, mg, mgx);
          store_f<T, V>(dx + (it - 1 - q) * step, xf);
        }
      }
      for (; it > n_st; --it) {
        float xf[V], gf[V];
        load_f<T, V>(x + (it - 1) * step, xf);
        load_f<T, V>(gp + (it - 1) * step, gf);
        bwd_dx(xf, gf, p, has_slope, mg, mgx);
        store_f<T, V>(dx + (it - 1) * step, xf);
      }
      if constexpr (V > 1) {
#pragma unroll 4
        for (; it > 0; --it) {
          float xf[V], gf[V];
          to_floats<T, V>(stash[2 * (it - 1) * T_ + t], xf);
          to_floats<T, V>(stash[(2 * (it - 1) + 1) * T_ + t], gf);
          bwd_dx(xf, gf, p, has_slope, mg, mgx);
          store_f<T, V>(dx + (it - 1) * step, xf);
        }
      }
    }
    __syncthreads();  // the scratch is reused by the next group
  }
}

// The kernel of a path: 0 the forward on chip, 1 the forward's persistent grid, 2 the
// backward on chip, 3 the backward's persistent grid; vec 16 / sizeof(T), or 1 for the
// persistent grids' general path.
template <typename T>
const void* kernel_of(int path, int vec) {
  constexpr int kV = 16 / sizeof(T);
  if (path == 0) return vec == kV ? reinterpret_cast<const void*>(&norm_onchip<T, kV>) : nullptr;
  if (path == 2) return vec == kV ? reinterpret_cast<const void*>(&norm_bwd_onchip<T, kV>) : nullptr;
  if (path == 1) {
    if (vec == kV) return reinterpret_cast<const void*>(&norm_persistent<T, kV>);
    return vec == 1 ? reinterpret_cast<const void*>(&norm_persistent<T, 1>) : nullptr;
  }
  if (path == 3) {
    if (vec == kV) return reinterpret_cast<const void*>(&norm_bwd_persistent<T, kV>);
    return vec == 1 ? reinterpret_cast<const void*>(&norm_bwd_persistent<T, 1>) : nullptr;
  }
  return nullptr;
}

const void* pick_kernel(int dtype, int path, int vec) {
  if (dtype == 0) return kernel_of<float>(path, vec);
  if (dtype == 1) return kernel_of<__nv_bfloat16>(path, vec);
  if (dtype == 2) return kernel_of<__half>(path, vec);
  return nullptr;
}

// cudaFuncSetAttribute for the kernel's dynamic shared memory, called again only when a
// launch needs more than the largest size set so far (a driver call saved a launch).
cudaError_t allow_smem(const void* kern, int smem) {
  static const void* kerns[32];
  static int sizes[32];
  int i = 0;
  for (; i < 32 && kerns[i] != nullptr && kerns[i] != kern; ++i) {
  }
  if (i < 32 && kerns[i] == kern && sizes[i] >= smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && i < 32) {
    kerns[i] = kern;
    sizes[i] = smem;
  }
  return err;
}

// A launch's result: err where the launch or a call before it failed, with the runtime's
// record of that error cleared (the caller's next launch would read it; the caller raises
// with it), else cudaGetLastError().
cudaError_t cleared(cudaError_t err) {
  if (err == cudaSuccess) return cudaGetLastError();
  cudaGetLastError();
  return err;
}

}  // namespace

// Blocks of the kernel of (dtype, path, vec) an SM holds at `threads` threads and `smem`
// bytes of dynamic shared memory, into *out; path as kernel_of's. Returns a cudaError_t.
extern "C" int monai_instance_norm_occupancy(int dtype, int path, int vec, int threads, int smem, int* out) {
  const void* kern = pick_kernel(dtype, path, vec);
  if (kern == nullptr || threads < 1 || threads > kMaxThreads || smem < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, threads, (size_t)smem);
}

// One launch of a plan, as instance_norm_plan gives it, on x (B, S, C) into y. plan: B,
// S, C, the dtype (0 float32, 1 bfloat16, 2 float16), the path (0 on chip, 1
// persistent), vec, G, threads, blocks, per_unit, units_per_group and the dynamic shared
// memory in bytes, and the vectors a thread of the persistent path keeps in shared
// memory. params: the types of w, b and a (2 bits each) and, from bit 6 up, the
// slope's length (0, 1 or C). scratch: for the persistent path, the barrier's two words,
// which must be 0 at the first launch that uses them, then 2 units per_unit G floats of
// partial sums; every launch leaves the barrier's count at 0, so launches in one stream
// may share one scratch. stats: null, or [2][B][C] float32 that gets each instance's
// per-channel mean and rsqrt(var + eps), which the backward reads. Returns a
// cudaError_t: the launch's, or cudaGetLastError() after it.
extern "C" int monai_instance_norm(const void* x, void* y, const void* w, const void* b, const void* a,
                                   void* scratch, float* stats, const long long* plan, float eps, int params,
                                   void* stream) {
  const long long B = plan[0], S = plan[1];
  const int C = (int)plan[2], dtype = (int)plan[3], path = (int)plan[4], vec = (int)plan[5], G = (int)plan[6];
  const int threads = (int)plan[7], blocks = (int)plan[8], per_unit = (int)plan[9];
  const int units_per_group = (int)plan[10], smem = (int)plan[11], stash = (int)plan[12];
  const int a_n = params >> 6;
  const void* kern = pick_kernel(dtype, path, vec);
  if (kern == nullptr || B < 1 || S < 1 || C < 1 || G < 1 || C % G != 0 || threads < 1 || threads > kMaxThreads ||
      blocks < 1 || smem < 0)
    return (int)cudaErrorInvalidValue;
  if ((w == nullptr) != (b == nullptr) || (a_n != 0 && a_n != 1 && a_n != C) || (a_n != 0) != (a != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool packed = vec > 1 && G % vec != 0;  // a vector holds vec / C voxels
  if (packed && (G != C || vec % C != 0 || (S * C) % vec != 0)) return (int)cudaErrorInvalidValue;
  if (vec > 1 && reinterpret_cast<unsigned long long>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  NormArgs args;
  args.x = x;
  args.y = y;
  args.w = w;
  args.b = b;
  args.a = a;
  args.w_type = params & 3;
  args.b_type = (params >> 2) & 3;
  args.a_type = (params >> 4) & 3;
  args.a_n = a_n;
  args.S = S;
  args.C = C;
  args.G = G;
  args.groups = C / G;
  args.gv = packed ? 1 : G / vec;
  args.rowstride = G == C ? (long long)args.gv * vec : C;
  args.nvec = S * G / vec;
  args.units = (int)(B * args.groups);
  args.inv_n = 1.0f / (float)S;
  args.eps = eps;
  args.stats = stats;
  args.stat_stride = B * C;
  if (threads % args.gv != 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  if (path == 0) {
    if (blocks != args.units || args.nvec * 16 > smem) return (int)cudaErrorInvalidValue;
    args.partial = nullptr;
    args.bar = nullptr;
    args.per_unit = args.units_per_group = args.unit_groups = 1;
    args.stash = 0;
    if (dtype == 0) norm_onchip<float, 4><<<blocks, threads, smem, st>>>(args);
    else if (dtype == 1) norm_onchip<__nv_bfloat16, 8><<<blocks, threads, smem, st>>>(args);
    else norm_onchip<__half, 8><<<blocks, threads, smem, st>>>(args);
    return (int)cudaGetLastError();
  }
  if (per_unit < 1 || units_per_group < 1 || blocks != per_unit * units_per_group || scratch == nullptr ||
      ((long long)per_unit * threads) % args.gv != 0 || stash < 0 || (vec == 1 && stash != 0) ||
      4LL * ((scratch_floats(threads, vec, G) + 3) / 4) + 16LL * stash * threads > smem)
    return (int)cudaErrorInvalidValue;
  args.stash = stash;
  args.per_unit = per_unit;
  args.units_per_group = units_per_group;
  args.unit_groups = (args.units + units_per_group - 1) / units_per_group;
  args.bar = static_cast<unsigned*>(scratch);
  args.partial = static_cast<float*>(scratch) + 2;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(threads), kargs, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward of monai_instance_norm (with its slope) for g on x (B, S, C) into dx, from
// the forward's stats ([2][B][C]: mean, rsqrt(var + eps)), in one launch. plan: B, S, C,
// the dtype (0 float32, 1 bfloat16, 2 float16; x, g and dx), the path (0 on chip, 1
// persistent), vec, G, threads, blocks, per_unit, units_per_group, the dynamic shared
// memory in bytes and the vectors of x and of g a thread of the persistent path keeps in
// shared memory, as instance_norm_backward_plan gives them. params: as
// monai_instance_norm's. scratch: for the persistent path, the barrier's two words (0 at
// the first launch that uses them; every launch leaves the count at 0, so the forward's
// and the backward's launches in one stream may share one scratch), then 3 units per_unit
// G floats of partial sums. sums: [3][B][C] float32, sum(gz), sum(gz x^) and
// sum(g z [z < 0]) of each instance and channel. Returns a cudaError_t: the launch's, or
// cudaGetLastError() after it; a refused launch leaves no error behind for the next one.
extern "C" int monai_instance_norm_backward(const void* x, const void* g, void* dx, const float* stats,
                                            const void* w, const void* b, const void* a, void* scratch, float* sums,
                                            const long long* plan, int params, void* stream) {
  const long long B = plan[0], S = plan[1];
  const int C = (int)plan[2], dtype = (int)plan[3], path = (int)plan[4], vec = (int)plan[5], G = (int)plan[6];
  const int threads = (int)plan[7], blocks = (int)plan[8], per_unit = (int)plan[9];
  const int units_per_group = (int)plan[10], smem = (int)plan[11], stash = (int)plan[12];
  const int a_n = params >> 6;
  const void* kern = path == 0 || path == 1 ? pick_kernel(dtype, path + 2, vec) : nullptr;
  if (kern == nullptr || B < 1 || S < 1 || C < 1 || G < 1 || C % G != 0 || threads < 1 || threads > kMaxThreads ||
      blocks < 1 || smem < 0 || stats == nullptr || sums == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((w == nullptr) != (b == nullptr) || (a_n != 0 && a_n != 1 && a_n != C) || (a_n != 0) != (a != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool packed = vec > 1 && G % vec != 0;  // a vector holds vec / C voxels
  if (packed && (G != C || vec % C != 0 || (S * C) % vec != 0)) return (int)cudaErrorInvalidValue;
  if (vec > 1 && (reinterpret_cast<unsigned long long>(x) % 16 != 0 ||
                  reinterpret_cast<unsigned long long>(g) % 16 != 0 ||
                  reinterpret_cast<unsigned long long>(dx) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  BwdArgs args;
  args.x = x;
  args.g = g;
  args.dx = dx;
  args.stats = stats;
  args.w = w;
  args.b = b;
  args.a = a;
  args.w_type = params & 3;
  args.b_type = (params >> 2) & 3;
  args.a_type = (params >> 4) & 3;
  args.a_n = a_n;
  args.sums = sums;
  args.S = S;
  args.stat_stride = B * C;
  args.C = C;
  args.G = G;
  args.groups = C / G;
  args.gv = packed ? 1 : G / vec;
  args.rowstride = G == C ? (long long)args.gv * vec : C;
  args.nvec = S * G / vec;
  args.units = (int)(B * args.groups);
  args.inv_n = 1.0f / (float)S;
  if (threads % args.gv != 0) return (int)cudaErrorInvalidValue;
  const long long base = 16LL * ((bwd_scratch_floats(threads, vec, G) + 3) / 4);  // the scratch, in bytes
  const auto st = static_cast<cudaStream_t>(stream);
  void* kargs[] = {&args};
  if (path == 0) {
    if (blocks != args.units || 2 * args.nvec * 16 + base > smem) return (int)cudaErrorInvalidValue;
    args.bar = nullptr;
    args.partial = nullptr;
    args.per_unit = args.units_per_group = args.unit_groups = 1;
    args.stash = 0;
    cudaError_t err = allow_smem(kern, smem);
    if (err == cudaSuccess) err = cudaLaunchKernel(kern, dim3(blocks), dim3(threads), kargs, (size_t)smem, st);
    return (int)cleared(err);
  }
  if (per_unit < 1 || units_per_group < 1 || blocks != per_unit * units_per_group || scratch == nullptr ||
      stash < 0 || (vec == 1 && stash != 0) || base + 32LL * stash * threads > smem)
    return (int)cudaErrorInvalidValue;
  args.bar = static_cast<unsigned*>(scratch);
  args.partial = static_cast<float*>(scratch) + 2;
  args.per_unit = per_unit;
  args.units_per_group = units_per_group;
  args.unit_groups = (args.units + units_per_group - 1) / units_per_group;
  args.stash = stash;
  cudaError_t err = allow_smem(kern, smem);
  if (err == cudaSuccess) err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(threads), kargs, (size_t)smem, st);
  return (int)cleared(err);
}
