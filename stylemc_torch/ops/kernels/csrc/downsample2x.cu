// 2x FIR downsample of float32 NCHW planes: the backward pass of the ToRGB
// skip chain's upsample (and the op downsample2d with a 4-tap filter).
//
// Replaces the TPU kernel stylemc_tpu/ops/pallas/upfirdn2d_pallas.py,
// function _downsample2x_core (body _make_down_kernel, _down_rows). Same
// function: a stride-2 correlation with a separable 4-tap filter g
// (canonical taps, gain folded in) and implicit padding (1, 1), zero
// outside the plane,
//
//   out[m][n] = sum_{a,b} g[a] * g[b] * x[2m + a - 1][2n + b - 1]
//
// The vertical pass runs first, then the horizontal one. It takes any even
// plane size, not only the row-tiled shapes of the TPU kernel, and needs no
// transposes: each thread reads the rows it needs directly.
//
// What bounds it on an H100: bytes. Each output element reads a 4x4 input
// window, but neighbouring outputs share half of it, so device memory sees
// each input element once (16 B per output) and each output once (4 B), for
// 24 flops per output in the separable form (this kernel does 40). At the largest training shape, [4,3,256,256] in and
// [4,3,128,128] out, that is 3.9 MB, about 1.2 us at 3.35 TB/s; every
// training shape is as small or smaller, so the launch bounds it in practice.
//
// Design: one thread per output pixel. It reads its 4x4 window with __ldg
// (the read-only path; neighbouring threads of a warp share the loads
// through L1), does the two passes in registers and writes one float.
// Threads of a warp own consecutive output columns, so a warp's reads of one
// input row span 66 contiguous floats and its store is one contiguous
// 128-byte segment. A grid-stride loop with 64-bit indices covers any
// number of planes.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
downsample2x_kernel(const float* __restrict__ x, float* __restrict__ y,
                    long long planes, int h, int w,
                    float g0, float g1, float g2, float g3) {
  // h, w: the output plane; the input plane is 2h x 2w
  const long long outputs = planes * h * w;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const float g[4] = {g0, g1, g2, g3};
  const int hi = 2 * h, wi = 2 * w;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < outputs; q += step) {
    const int j = static_cast<int>(q % w);
    const long long t = q / w;
    const int i = static_cast<int>(t % h);
    const long long p = t / h;
    const float* xp = x + p * hi * static_cast<long long>(wi);

    // vertical pass: v[c] = sum_a g[a] * x[2i + a - 1][2j + c - 1]
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = 2 * j + c - 1;
      const bool col_ok = jj >= 0 && jj < wi;
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ii = 2 * i + a - 1;
        const float xv = (col_ok && ii >= 0 && ii < hi)
                             ? __ldg(xp + static_cast<long long>(ii) * wi + jj)
                             : 0.0f;
        s += g[a] * xv;
      }
      v[c] = s;
    }
    // horizontal pass
    float out = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) out += g[c] * v[c];
    y[q] = out;
  }
}

}  // namespace

// x: [planes, 2h, 2w] float32, y: [planes, h, w] float32, both contiguous
// on the current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int stylemc_downsample2x(const void* x, void* y, long long planes,
                                    int h, int w, float g0, float g1,
                                    float g2, float g3, void* stream) {
  const long long outputs = planes * h * w;
  if (outputs <= 0) return 0;
  const int threads = 256;
  long long blocks = (outputs + threads - 1) / threads;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;  // grid-stride covers the rest
  downsample2x_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), planes, h, w, g0,
      g1, g2, g3);
  return static_cast<int>(cudaGetLastError());
}
