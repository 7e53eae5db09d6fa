// Brute-force bilateral filter of float32 planes, 2-D and 3-D, forward:
//
//   out[v] = sum_o ws[o] * wc(o, v) * x[clamp(v + o)] / max(sum_o ws[o] * wc(o, v), 1e-8)
//   wc(o, v) = exp(-(x[clamp(v + o)] - x[v])^2 * 0.5 / color_sigma^2)
//
// for every voxel v of every (batch, channel) plane, o over the cube [-r, r]^sd in row-major
// order (the slowest axis outermost). ws is the host-built float32 table of the spatial
// weights exp(-|o|^2 * 0.5 / spatial_sigma^2), one entry per tap in that order. The clamped
// index is the edge padding, so no padded copy is made and sizes <= r work. Sums are float32.
//
// Replaces monai_tpu/ops/pallas_filtering.py::_run_2d (body _kernel_2d) and ::_run_3d (body
// _kernel_3d). Those DMA'd an edge-padded slab with its halo into VMEM and statically
// unrolled the taps, which capped the radius (6 in 2-D, 2 in 3-D) and the slab size. Here
// the radius is a runtime value and any radius is taken.
//
// What bounds it on the card: the special-function unit's exp, 16 a clock on each SM
// against 128 float32 operations. Each weight is symmetric in the pair (v, v + o) and the
// centre's is 1, so the function needs (T - 1) / 2 exps a voxel of T taps (62 for a 3-D
// r = 2 filter), with 4 operations each and 3 more a tap for the sums; the exps set the
// bound, the operations come close, and the 8 bytes a voxel moves are far below. This
// kernel does one exp a tap, twice that least count; sharing each pair's weight between
// neighbours is the next step. The design keeps the rest off the exp unit's way: the
// spatial exponent is the table, read by the whole warp from one address, and the taps
// come from shared memory, where a block stages its output tile with the halo of r
// (clamped reads) once. Where tile and halo outgrow kSharedBudget (2-D beyond r = 45, 3-D
// beyond r = 5), the same kernel reads the taps from global memory (L2) instead.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;  // threads along the contiguous axis: one warp a row
constexpr int kTileY = 8;
constexpr int kTileZ = 4;   // 3-D: each thread computes kTileZ voxels along z
constexpr int kThreads = kTileX * kTileY;
constexpr int kSharedBudget = 48 * 1024;  // bytes: the default per block, no opt-in needed

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ void accumulate(float v, float c, float ws, float inv2cs, float& num, float& den) {
  const float d = v - c;
  const float w = ws * expf(-(d * d) * inv2cs);
  num = fmaf(w, v, num);
  den += w;
}

// One block per (plane, 8-row, 32-column) tile; blockIdx.x enumerates them.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
bilateral_2d_kernel(const float* __restrict__ in, float* __restrict__ out, const float* __restrict__ ws, int h,
                    int w, int r, float inv2cs, int tiles_x, int tiles_y) {
  extern __shared__ float tile[];
  const int bx = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int by = rest % tiles_y;
  const long long plane = (long long)(rest / tiles_y) * h * w;
  const float* src = in + plane;
  const int x0 = bx * kTileX, y0 = by * kTileY;
  const int tw = kTileX + 2 * r, th = kTileY + 2 * r;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (kShared) {
    for (int i = ty * kTileX + tx; i < tw * th; i += kThreads) {
      const int ly = i / tw, lx = i - ly * tw;
      tile[i] = __ldg(src + (long long)clampi(y0 - r + ly, h - 1) * w + clampi(x0 - r + lx, w - 1));
    }
    __syncthreads();
  }
  const int x = x0 + tx, y = y0 + ty;
  if (x >= w || y >= h) return;
  const float c = kShared ? tile[(ty + r) * tw + tx + r] : __ldg(src + (long long)y * w + x);
  float num = 0.f, den = 0.f;
  int t = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const float* row = kShared ? tile + (ty + r + dy) * tw + tx + r : src + (long long)clampi(y + dy, h - 1) * w;
    for (int dx = -r; dx <= r; ++dx, ++t) {
      const float v = kShared ? row[dx] : __ldg(row + clampi(x + dx, w - 1));
      accumulate(v, c, __ldg(ws + t), inv2cs, num, den);
    }
  }
  out[plane + (long long)y * w + x] = num / fmaxf(den, 1e-8f);
}

// One block per (plane, 4-slice, 8-row, 32-column) tile; each thread walks its 4 slices.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
bilateral_3d_kernel(const float* __restrict__ in, float* __restrict__ out, const float* __restrict__ ws, int d,
                    int h, int w, int r, float inv2cs, int tiles_x, int tiles_y, int tiles_z) {
  extern __shared__ float tile[];
  const int bx = blockIdx.x % tiles_x;
  int rest = blockIdx.x / tiles_x;
  const int by = rest % tiles_y;
  rest /= tiles_y;
  const int bz = rest % tiles_z;
  const long long plane = (long long)(rest / tiles_z) * d * h * w;
  const float* src = in + plane;
  const int x0 = bx * kTileX, y0 = by * kTileY, z0 = bz * kTileZ;
  const int tw = kTileX + 2 * r, th = kTileY + 2 * r, td = kTileZ + 2 * r;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (kShared) {
    for (int i = ty * kTileX + tx; i < tw * th * td; i += kThreads) {
      const int lz = i / (tw * th);
      const int j = i - lz * tw * th;
      const int ly = j / tw, lx = j - ly * tw;
      tile[i] = __ldg(src + ((long long)clampi(z0 - r + lz, d - 1) * h + clampi(y0 - r + ly, h - 1)) * w +
                      clampi(x0 - r + lx, w - 1));
    }
    __syncthreads();
  }
  const int x = x0 + tx, y = y0 + ty;
  if (x >= w || y >= h) return;
  for (int lz = 0; lz < kTileZ; ++lz) {
    const int z = z0 + lz;
    if (z >= d) break;
    const float c = kShared ? tile[((lz + r) * th + ty + r) * tw + tx + r]
                            : __ldg(src + ((long long)z * h + y) * w + x);
    float num = 0.f, den = 0.f;
    int t = 0;
    for (int dz = -r; dz <= r; ++dz) {
      for (int dy = -r; dy <= r; ++dy) {
        const float* row = kShared ? tile + ((lz + r + dz) * th + ty + r + dy) * tw + tx + r
                                   : src + ((long long)clampi(z + dz, d - 1) * h + clampi(y + dy, h - 1)) * w;
        for (int dx = -r; dx <= r; ++dx, ++t) {
          const float v = kShared ? row[dx] : __ldg(row + clampi(x + dx, w - 1));
          accumulate(v, c, __ldg(ws + t), inv2cs, num, den);
        }
      }
    }
    out[plane + ((long long)z * h + y) * w + x] = num / fmaxf(den, 1e-8f);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// in and out: (planes, [d,] h, w) contiguous float32, sd = 2 (d ignored) or 3. spatial_w:
// (2r+1)^sd float32 on the card, row-major over the offsets. inv2cs = 0.5 / color_sigma^2.
// Returns a cudaError_t (0 on success); launches on `stream` and does not synchronise.
extern "C" int monai_bilateral_filter(const void* in, void* out, const void* spatial_w, long long planes, int sd,
                                      int d, int h, int w, int radius, float inv2cs, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || radius < 0 || (sd != 2 && sd != 3) || (sd == 3 && d <= 0))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(in);
  auto* dst = static_cast<float*>(out);
  const auto* ws = static_cast<const float*>(spatial_w);
  const int tiles_x = ceil_div(w, kTileX), tiles_y = ceil_div(h, kTileY);
  const int tiles_z = sd == 3 ? ceil_div(d, kTileZ) : 1;
  const long long blocks = planes * tiles_x * tiles_y * tiles_z;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kTileX, kTileY);
  const long long halo_w = kTileX + 2LL * radius, halo_h = kTileY + 2LL * radius;
  const long long shared = (sd == 3 ? kTileZ + 2LL * radius : 1LL) * halo_h * halo_w * (long long)sizeof(float);
  const bool staged = shared <= kSharedBudget;
  const size_t bytes = staged ? (size_t)shared : 0;
  if (sd == 2) {
    if (staged)
      bilateral_2d_kernel<true><<<(unsigned)blocks, block, bytes, s>>>(src, dst, ws, h, w, radius, inv2cs,
                                                                      tiles_x, tiles_y);
    else
      bilateral_2d_kernel<false><<<(unsigned)blocks, block, 0, s>>>(src, dst, ws, h, w, radius, inv2cs, tiles_x,
                                                                    tiles_y);
  } else {
    if (staged)
      bilateral_3d_kernel<true><<<(unsigned)blocks, block, bytes, s>>>(src, dst, ws, d, h, w, radius, inv2cs,
                                                                      tiles_x, tiles_y, tiles_z);
    else
      bilateral_3d_kernel<false><<<(unsigned)blocks, block, 0, s>>>(src, dst, ws, d, h, w, radius, inv2cs,
                                                                    tiles_x, tiles_y, tiles_z);
  }
  return (int)cudaGetLastError();
}
