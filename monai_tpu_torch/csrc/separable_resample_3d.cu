// Separable (diagonal-affine) resample of a channel-first float32 volume, forward:
//
//   out[c, i, j, k] = sum_a Wz[i, a] * sum_b Wy[j, b] * sum_e Wx[k, e] * in[c, a, b, e]
//
// contracted axis 1 first, then axis 2, then axis 3, as monai_tpu/ops/separable.py does.
// Each W is the host-built 1-D interpolation matrix of one axis (orders 0, 1 and 3; bounds
// zeros, border and reflection), handed to the kernel as a tap table: for output row i,
// `taps` input indices and float32 weights (a row's nonzeros in ascending index order,
// padded with weight 0). A null table marks an axis whose matrix is the identity; its
// pass is skipped.
//
// Replaces monai_tpu/ops/pallas_resample.py::_build_call (body _make_kernel). That kernel
// DMA'd an input z-slab into VMEM and contracted it with dense weight matrices on the MXU,
// where a dense product is cheap. Here a dense (n_out, n_in) product would do 128-512
// times the needed work (rows of up to 512 inputs against 1, 2 or 4 taps), so each output
// element sums its taps only, in float32 (fma in ascending index order).
//
// What bounds it on the card: memory. Orders 0 and 1 do 1-2 FMAs per element and pass
// read; order 3 does 4. One pass per axis, each a grid-stride loop over its output with
// neighbouring threads on the contiguous last axis (the axis-3 pass gathers along it), and
// float32 intermediates between the passes: the passes move more than the bound's one
// read of the input and one write of the output (the spleen path's forward site moves
// ~0.31 GB against the bound's 0.16 GB; its inverse ~0.88 GB, as the upsampling axes come
// first). Fusing the passes per output tile, with the axis-1-contracted slab in shared
// memory, is the next step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

// One axis: in viewed as (outer, n_in, inner), out as (outer, n_out, inner).
template <typename I>
__global__ void __launch_bounds__(kThreads)
resample_axis_kernel(const float* __restrict__ in, float* __restrict__ out, I total, I n_out, I inner, I n_in,
                     const int* __restrict__ idx, const float* __restrict__ w, int taps) {
  for (I e = (I)blockIdx.x * kThreads + threadIdx.x; e < total; e += (I)gridDim.x * kThreads) {
    const I n = e % inner;
    const I row = e / inner;  // o * n_out + i
    const I i = row % n_out;
    const I o = row / n_out;
    const float* src = in + o * n_in * inner + n;
    const int* ti = idx + i * taps;
    const float* tw = w + i * taps;
    float acc = 0.f;
    for (int t = 0; t < taps; ++t) acc = fmaf(__ldg(tw + t), __ldg(src + (I)__ldg(ti + t) * inner), acc);
    out[e] = acc;
  }
}

cudaError_t resample_axis(const float* in, float* out, long long outer, int n_in, int n_out, long long inner,
                          const int* idx, const float* w, int taps, cudaStream_t stream) {
  if (taps <= 0 || n_in <= 0 || n_out <= 0) return cudaErrorInvalidValue;
  const long long total = outer * n_out * inner;
  const long long largest = total > outer * n_in * inner ? total : outer * n_in * inner;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (largest < (1LL << 30)) {  // 32-bit index math, with room for the grid stride
    resample_axis_kernel<int32_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, (int32_t)total, n_out, (int32_t)inner, n_in, idx, w, taps);
  } else {
    resample_axis_kernel<int64_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, total, n_out, inner, n_in, idx, w, taps);
  }
  return cudaGetLastError();
}

}  // namespace

// in (C, zin, yin, xin) and out (C, zout, yout, xout), contiguous float32. Per axis a tap
// table (idx int32 and w float32, each (n_out, taps)), or null idx for an identity axis
// (then n_in == n_out). tmp1 (C, zout, yin, xin) is needed when the z pass is not the
// last one that runs, tmp2 (C, zout, yout, xin) when the y pass is not. Returns a
// cudaError_t (0 on success); launches on `stream` and does not synchronise.
extern "C" int monai_separable_resample_3d(const void* in, void* out, void* tmp1, void* tmp2, long long C, int zin,
                                           int yin, int xin, int zout, int yout, int xout, const void* iz,
                                           const void* wz, int tz, const void* iy, const void* wy, int ty,
                                           const void* ix, const void* wx, int tx, void* stream) {
  if (C <= 0 || zin <= 0 || yin <= 0 || xin <= 0 || zout <= 0 || yout <= 0 || xout <= 0)
    return (int)cudaErrorInvalidValue;
  if ((!iz && zin != zout) || (!iy && yin != yout) || (!ix && xin != xout)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(in);
  auto* dst_final = static_cast<float*>(out);
  if (!iz && !iy && !ix) {
    return (int)cudaMemcpyAsync(dst_final, src, (size_t)C * zin * yin * xin * sizeof(float),
                                cudaMemcpyDeviceToDevice, s);
  }
  const int last = ix ? 2 : (iy ? 1 : 0);
  cudaError_t err;
  if (iz) {
    float* dst = last == 0 ? dst_final : static_cast<float*>(tmp1);
    if (!dst) return (int)cudaErrorInvalidValue;
    err = resample_axis(src, dst, C, zin, zout, (long long)yin * xin, static_cast<const int*>(iz),
                        static_cast<const float*>(wz), tz, s);
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  if (iy) {
    float* dst = last == 1 ? dst_final : static_cast<float*>(tmp2);
    if (!dst) return (int)cudaErrorInvalidValue;
    err = resample_axis(src, dst, C * zout, yin, yout, xin, static_cast<const int*>(iy),
                        static_cast<const float*>(wy), ty, s);
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  if (ix) {
    err = resample_axis(src, dst_final, C * zout * yout, xin, xout, 1, static_cast<const int*>(ix),
                        static_cast<const float*>(wx), tx, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
