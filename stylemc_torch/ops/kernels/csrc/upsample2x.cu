// 2x FIR upsample of float32 NCHW planes: the ToRGB skip chain of the
// StyleGAN2 synthesis network.
//
// Replaces the TPU kernel stylemc_tpu/ops/pallas/upfirdn2d_pallas.py,
// function _upsample2x_core (body _make_up_kernel). Same function:
// upsample2d with a separable 4-tap filter g (canonical taps, gain 4
// folded in) and implicit padding (2, 1), in polyphase form with a zero
// boundary,
//
//   even[m] = g0 * x[m-1] + g2 * x[m]
//   odd[m]  = g1 * x[m]   + g3 * x[m+1]
//
// applied to the rows, then to the columns. It takes any plane size, not
// only the row-tiled shapes of the TPU kernel, and never builds a
// zero-stuffed intermediate.
//
// What bounds it on an H100: bytes. Each input element is read once (4 B)
// and yields one 2x2 output quad (16 B) for about 12 flops, far below the
// card's flops-per-byte ratio. At batch 16 the 128^2 -> 256^2 plane moves
// 3.1 MB in and 12.6 MB out, 15.7 MB, about 4.7 us at 3.35 TB/s. The
// chain's small planes (4^2 .. 32^2) move at most a few hundred kB and are
// bound by the launch itself.
//
// Design: one thread per output quad. It reads its 3x3 input neighbourhood
// (neighbouring threads share six of the nine loads through L1), does both
// passes in registers and writes the quad as two float2 stores. Threads of
// a warp own consecutive columns, so each store row of a warp is one
// contiguous 256-byte segment. A grid-stride loop with 64-bit indices
// covers any number of planes.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
upsample2x_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long planes, int h, int w,
                  float g0, float g1, float g2, float g3) {
  const long long quads = planes * h * w;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < quads; q += step) {
    const int j = static_cast<int>(q % w);
    const long long t = q / w;
    const int i = static_cast<int>(t % h);
    const long long p = t / h;
    const float* xp = x + p * h * w;

    float v[3][3];  // v[r][c] = x[i + r - 1][j + c - 1], zero outside
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int ii = i + r - 1;
      const bool row_ok = ii >= 0 && ii < h;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int jj = j + c - 1;
        v[r][c] = (row_ok && jj >= 0 && jj < w)
                      ? __ldg(xp + static_cast<long long>(ii) * w + jj)
                      : 0.0f;
      }
    }

    // vertical pass: output rows 2i (even) and 2i+1 (odd)
    float ve[3], vo[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ve[c] = g0 * v[0][c] + g2 * v[1][c];
      vo[c] = g1 * v[1][c] + g3 * v[2][c];
    }
    // horizontal pass: output columns 2j and 2j+1
    const float2 top = make_float2(g0 * ve[0] + g2 * ve[1],
                                   g1 * ve[1] + g3 * ve[2]);
    const float2 bot = make_float2(g0 * vo[0] + g2 * vo[1],
                                   g1 * vo[1] + g3 * vo[2]);

    const long long w2 = 2LL * w;
    float* yp = y + p * 4LL * h * w + 2LL * i * w2 + 2LL * j;
    *reinterpret_cast<float2*>(yp) = top;
    *reinterpret_cast<float2*>(yp + w2) = bot;
  }
}

}  // namespace

// x: [planes, h, w] float32, y: [planes, 2h, 2w] float32, both contiguous
// on the current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int stylemc_upsample2x(const void* x, void* y, long long planes,
                                  int h, int w, float g0, float g1, float g2,
                                  float g3, void* stream) {
  const long long quads = planes * h * w;
  if (quads <= 0) return 0;
  const int threads = 256;
  long long blocks = (quads + threads - 1) / threads;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;  // grid-stride covers the rest
  upsample2x_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), planes, h, w, g0,
      g1, g2, g3);
  return static_cast<int>(cudaGetLastError());
}
