// The tensor cores' rate through mma.sync.m16n8k8 TF32, the instruction
// that B3 and B5 (ops/kernels/csrc/modconv_fwd.cu, modconv_bwd_weight.cu)
// are built on: each warp keeps 16 independent accumulators and issues
// `iters` rounds of 16 MMAs on operands held in registers, so nothing but
// the tensor cores bounds it. A yardstick for B3's and B5's TFLOP/s; no
// path of the port runs it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ACC = 16;

__global__ void mma_tf32_loop(float* out, int iters, uint32_t seed) {
  float c[ACC][4];
#pragma unroll
  for (int i = 0; i < ACC; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  const uint32_t a[4] = {seed, seed ^ 1u, seed ^ 2u, seed ^ 3u};
  const uint32_t b[2] = {seed ^ 5u, seed ^ 7u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < ACC; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// blocks x threads threads, each warp 16 * iters MMAs of 2*16*8*8 flops;
// out holds blocks * threads floats. Returns cudaGetLastError().
extern "C" int stylemc_mma_tf32_loop(int blocks, int threads, int iters,
                                     void* out, void* stream) {
  mma_tf32_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters, 0x3f800000u);
  return static_cast<int>(cudaGetLastError());
}
