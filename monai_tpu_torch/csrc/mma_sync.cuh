// Inline PTX for Hopper's asynchronous copies and warp-level tensor-core products,
// shared by the kernels that stage tiles by cp.async and multiply them by mma.sync:
// the 3x3x3 conv (conv3d_3x3_same.cu) and window attention's forward and backward
// (window_attention.cu, window_attention_bwd.cu, which take the 3xTF32 products below);
// the resample (separable_resample_3d.cu) takes its cp.async helpers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory (both 16-byte aligned); the first src_bytes (0 to 16)
// are read and the rest filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x1_t(unsigned& r0, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n" : "=r"(r0) : "r"(smem_addr(p)));
}

// d += a b on the tensor cores, f32 accumulate: m16n8k16 and m16n8k8
template <typename T> __device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                                              unsigned b1);
template <> __device__ __forceinline__ void mma_k16<__nv_bfloat16>(float (&d)[4], const unsigned (&a)[4],
                                                                   unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
               "{%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <> __device__ __forceinline__ void mma_k16<__half>(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                                            unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
               "{%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <typename T> __device__ __forceinline__ void mma_k8(float (&d)[4], unsigned a0, unsigned a1, unsigned b0);
template <> __device__ __forceinline__ void mma_k8<__nv_bfloat16>(float (&d)[4], unsigned a0, unsigned a1,
                                                                  unsigned b0) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(a1), "r"(b0));
}
template <> __device__ __forceinline__ void mma_k8<__half>(float (&d)[4], unsigned a0, unsigned a1, unsigned b0) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(a1), "r"(b0));
}

// x as big + small, each a TF32 value (a float's low 13 bits cleared, which mma.sync
// ignores): the 3xTF32 split, by masks and a subtraction (x - big is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An m16n8k8 operand pair, split: A (16 x 8, a[0..3] at (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) of lane 4 g + t) and B (8 x 8, b[0..1] at (t, g), (t + 4, g)); C (16 x 8)
// at (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8, 2 t + 1).
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// a b in 3xTF32 into two accumulators, main += a.big b.big and corr += a.small b.big +
// a.big b.small, so that a product's three mma form two short chains and not one long one
__device__ __forceinline__ void mma3(float (&main)[4], float (&corr)[4], const FragA& a, const FragB& b) {
  mma_tf32(corr, a.small, b.big[0], b.big[1]);
  mma_tf32(main, a.big, b.big[0], b.big[1]);
  mma_tf32(corr, a.big, b.small[0], b.small[1]);
}

}  // namespace
