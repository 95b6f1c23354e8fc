// Shared by the fused synthesis layer's tensor-core kernels (B3 and B4
// through modconv_igemm.cuh; B5, modconv_bwd_weight.cu): cp.async copies,
// the TF32 rounding and 3xTF32 split, and mma.sync.m16n8k8 TF32.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace modconv_tc {

__host__ __device__ constexpr int pow2_at_least(int v) {
  return v <= 1 ? 1 : 2 * pow2_at_least((v + 1) / 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros where !valid
// (src is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10 mantissa
// bits) for finite v, in its two integer operations: cvt also tests v for
// inf and NaN first, which doubles the CUDA-core work of a split
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small, both TF32 values (modconv.py tf32_split emulates it)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(v);
  small = rna_tf32(v - __uint_as_float(big));
}

// c += a b, a 16x8 (row-major), b 8x8 (column-major), TF32 in, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace modconv_tc
