// The fused modulated synthesis layer, forward (up 1, 3x3, pad 1), float32:
//
//   y[n,co] = clamp(lrelu(d[n,co] * sum_{ci,t} w[co,ci,t] * s[n,ci]
//                          * x[n,ci,. + off_t] + noise + b[co]) * gain)
//
// with d = rsqrt(s^2 . sum_t w^2 + 1e-8) computed by the wrapper.
//
// Replaces the TPU kernel stylemc_tpu/ops/pallas/modconv_pallas.py,
// functions _fwd_kernel / _fwd_call. Same function: the TPU kernel folds s
// and d into the nine taps and contracts [CO,CI] x [CI,(TH+2)*W] windows on
// the MXU; here s scales the input as it is staged and d scales the sum in
// the epilogue, which reassociates the products (the tests' tolerance
// covers it). The [N,C,H*W] lane layout, the column rolls and the 128-lane
// alignment of the TPU kernel are not carried over: any plane size works,
// 4x4 included.
//
// What bounds it on an H100: operations. 2*N*CO*CI*9*H*W flops against
// ((N*CI + N*CO)*H*W + 9*CI*CO)*4 bytes; at FFHQ-256's conv1 shapes (C =
// 512..128, batch 4) that is 0.3-77 GFLOP for 10-270 MB, above the fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 flop/byte at every layer, so the bound is the
// flops at 67 TFLOP/s (1.15 ms at the 256x256 layer).
//
// Design: an implicit GEMM on the CUDA cores (modconv_common.cuh). One block
// per (sample, 64 output channels, 16x16 pixel tile), 256 threads, each with
// an 8 x 8 fp32 register tile; input channels are staged 8 at a time with
// their one-pixel halo. The epilogue applies d, noise, bias, lrelu(0.2),
// gain and the clamp in registers and writes y once. Planes smaller than
// the tile (4x4, 8x8) leave most of a block idle; those layers hold 0.6 %
// of the layer stack's flops. No tensor cores (wgmma) yet.

#include "modconv_common.cuh"

namespace {

using namespace modconv;

__global__ void __launch_bounds__(THREADS)
modconv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ s, const float* __restrict__ d,
                   const float* __restrict__ noise,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int CI, int CO, int H, int W, float gain, float clamp,
                   int has_clamp) {
  __shared__ __align__(16) float xs[IN_TILE];
  __shared__ __align__(16) float ws[W_TILE];
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int i0 = (blockIdx.x / tiles_w) * TILE_H;
  const int j0 = (blockIdx.x % tiles_w) * TILE_W;
  const int m0 = blockIdx.y * TILE_M;
  const int n = blockIdx.z;

  float acc[8][8];
  conv3x3_mainloop(x, s, wt, n, CI, CO, H, W, m0, i0, j0, acc, xs, ws);

  const TileCoord tc = tile_coord();
  const int i = i0 + tc.r;
  if (i >= H) return;
  const long long plane = static_cast<long long>(H) * W;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int co = m0 + tc.mg * 8 + a;
    if (co >= CO) break;
    const float dm = __ldg(d + static_cast<long long>(n) * CO + co);
    const float bm = __ldg(bias + co);
    float* yrow = y + (static_cast<long long>(n) * CO + co) * plane +
                  static_cast<long long>(i) * W;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + tc.c0 + b;
      if (j < W) {
        const float z = acc[a][b] * dm + __ldg(noise + i * W + j) + bm;
        float v = (z >= 0.0f ? z : z * LRELU_SLOPE) * gain;
        if (has_clamp) v = fminf(fmaxf(v, -clamp), clamp);
        yrow[j] = v;
      }
    }
  }
}

}  // namespace

// x [N,CI,H,W], wt [CI,9,CO] (wt[ci][3*di+dj][co] = w[co][ci][di][dj]),
// s [N,CI], d [N,CO], noise [H,W], bias [CO] -> y [N,CO,H,W]; all float32,
// contiguous, on the current device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int stylemc_modconv_fwd(const void* x, const void* wt,
                                   const void* s, const void* d,
                                   const void* noise, const void* bias,
                                   void* y, int N, int CI, int CO, int H,
                                   int W, float gain, float clamp,
                                   int has_clamp, void* stream) {
  if (N <= 0 || CO <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid(tiles_of(H, W), (CO + TILE_M - 1) / TILE_M, N);
  modconv_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(s), static_cast<const float*>(d),
      static_cast<const float*>(noise), static_cast<const float*>(bias),
      static_cast<float*>(y), CI, CO, H, W, gain, clamp, has_clamp);
  return static_cast<int>(cudaGetLastError());
}
