// The fused modulated synthesis layer, backward to the data terms, float32:
// from the output cotangent dy and the saved output y,
//
//   dz      = dy * g(y)               g: lrelu/clamp gradient rebuilt from y
//   dxmod   = transposed 3x3 conv of dz * d[n,co] (flipped taps)
//   dx      = dxmod * s[n,ci]
//   ds_dir  = sum_px dxmod * x        (per n, ci; the direct style term)
//   db      = sum_px dz               (per n, co)
//   dd      = (sum dz*z1 - b*sum dz - sum dz*noise) / d    (per n, co)
//
// where z1 = lrelu^-1(y / gain) is the pre-activation rebuilt from y; the
// wrapper chains dd through d = rsqrt(.) into ds and dW.
//
// Replaces the TPU kernel stylemc_tpu/ops/pallas/modconv_pallas.py,
// functions _bwd_data_kernel / _bwd_data_call. Same function, but for the
// per-sample sum of dz * noise (the TPU kernel's fifth output), which its
// wrapper discards and which this port leaves out. The TPU kernel carries
// ds/dd/db across its sequential row-tile grid steps; blocks here run in no
// order, so each sum is owned by one block or written as per-tile partials
// that the wrapper sums: the results are deterministic, no atomics.
//
// What bounds it on an H100: operations. The transposed convolution is
// 2*N*CI*CO*9*H*W flops, as the forward; dy, y and x are read and dx
// written once, 16 bytes per element of a plane, far below the fp32 ridge
// of 20 flop/byte at FFHQ-256's conv1 shapes: 1.15 ms at 67 TFLOP/s for the
// 256x256 layer at batch 4.
//
// Design: two launches, counted as one call by the wrapper.
//  1. modconv_dz_kernel, one block per (n, co) plane: one pass over dy and
//     y builds dz with the mask, writes dz * d[n,co] to a scratch plane,
//     and reduces sum dz, sum dz*z1 and sum dz*noise in a fixed order (warp
//     shuffles, then the 8 warps in turn), from which it writes db and dd.
//  2. modconv_dx_kernel: the forward's implicit GEMM (modconv_common.cuh)
//     with the roles of CI and CO swapped, over the scratch planes, with
//     the flipped taps [CO][9][CI] prepared by the wrapper. Its epilogue
//     writes dx = dxmod * s and, per 16x16 tile, sum dxmod * x: a warp
//     holds one channel group over the whole tile, so a shuffle reduction
//     gives the tile's sum, which lane 0 writes to the partials
//     [N][CI][tiles].
// The scratch round trip costs 8 bytes per element of the CO planes, a few
// percent of the convolution's time at every conv1 shape.

#include "modconv_common.cuh"

namespace {

using namespace modconv;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
modconv_dz_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                  const float* __restrict__ d, const float* __restrict__ noise,
                  const float* __restrict__ bias, float* __restrict__ dzd,
                  float* __restrict__ dd, float* __restrict__ db, int CO,
                  int plane, float gain, float clamp, int has_clamp) {
  __shared__ float red[THREADS / 32][3];
  const long long q = blockIdx.x;                 // n * CO + co
  const int co = static_cast<int>(q % CO);
  const float dm = __ldg(d + q);
  const long long base = q * plane;
  float s_dz = 0.0f, s_t1 = 0.0f, s_t3 = 0.0f;
  for (int p = threadIdx.x; p < plane; p += THREADS) {
    const float yv = __ldg(y + base + p);
    const float dz = __ldg(dy + base + p) * act_grad(yv, gain, clamp, has_clamp);
    dzd[base + p] = dz * dm;
    const float a = yv / gain;
    const float z1 = a >= 0.0f ? a : a / LRELU_SLOPE;
    s_dz += dz;
    s_t1 += dz * z1;
    s_t3 += dz * __ldg(noise + p);
  }
  s_dz = warp_sum(s_dz);
  s_t1 = warp_sum(s_t1);
  s_t3 = warp_sum(s_t3);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp][0] = s_dz;
    red[warp][1] = s_t1;
    red[warp][2] = s_t3;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f, t3 = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) {
      t0 += red[w][0];
      t1 += red[w][1];
      t3 += red[w][2];
    }
    db[q] = t0;
    dd[q] = (t1 - __ldg(bias + co) * t0 - t3) / dm;
  }
}

__global__ void __launch_bounds__(THREADS)
modconv_dx_kernel(const float* __restrict__ dzd, const float* __restrict__ wtt,
                  const float* __restrict__ s, const float* __restrict__ x,
                  float* __restrict__ dx, float* __restrict__ ds_part, int CI,
                  int CO, int H, int W) {
  __shared__ __align__(16) float xs[IN_TILE];
  __shared__ __align__(16) float ws[W_TILE];
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tile = blockIdx.x;
  const int i0 = (tile / tiles_w) * TILE_H;
  const int j0 = (tile % tiles_w) * TILE_W;
  const int m0 = blockIdx.y * TILE_M;
  const int n = blockIdx.z;

  float acc[8][8];
  conv3x3_mainloop(dzd, nullptr, wtt, n, CO, CI, H, W, m0, i0, j0, acc, xs, ws);

  const TileCoord tc = tile_coord();
  const int i = i0 + tc.r;
  const long long plane = static_cast<long long>(H) * W;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int ci = m0 + tc.mg * 8 + a;       // the same for the whole warp
    if (ci >= CI) break;
    const float sm = __ldg(s + static_cast<long long>(n) * CI + ci);
    const long long row = (static_cast<long long>(n) * CI + ci) * plane +
                          static_cast<long long>(i) * W;
    float part = 0.0f;
    if (i < H) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int j = j0 + tc.c0 + b;
        if (j < W) {
          dx[row + j] = acc[a][b] * sm;
          part += acc[a][b] * __ldg(x + row + j);
        }
      }
    }
    part = warp_sum(part);
    if (threadIdx.x % 32 == 0)
      ds_part[(static_cast<long long>(n) * CI + ci) * gridDim.x + tile] = part;
  }
}

}  // namespace

// The number of 16x16 tiles of an h x w plane: the last extent of the
// ds partials that stylemc_modconv_bwd_data writes.
extern "C" int stylemc_modconv_bwd_data_tiles(int h, int w) { return tiles_of(h, w); }

// dy, y [N,CO,H,W], x [N,CI,H,W], wtt [CO,9,CI] (wtt[co][3*di+dj][ci] =
// w[co][ci][2-di][2-dj]), s [N,CI], d [N,CO], noise [H,W], bias [CO]; scratch
// dzd [N,CO,H,W]; out dx [N,CI,H,W], ds_part [N,CI,tiles], dd [N,CO],
// db [N,CO]. All float32, contiguous, on the current device. Two launches
// on `stream`; returns the first non-zero cudaGetLastError(), else 0.
extern "C" int stylemc_modconv_bwd_data(
    const void* dy, const void* y, const void* x, const void* wtt,
    const void* s, const void* d, const void* noise, const void* bias,
    void* dzd, void* dx, void* ds_part, void* dd, void* db, int N, int CI,
    int CO, int H, int W, float gain, float clamp, int has_clamp,
    void* stream) {
  if (N <= 0 || CI <= 0 || CO <= 0 || H <= 0 || W <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  modconv_dz_kernel<<<static_cast<unsigned int>(N) * CO, THREADS, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y),
      static_cast<const float*>(d), static_cast<const float*>(noise),
      static_cast<const float*>(bias), static_cast<float*>(dzd),
      static_cast<float*>(dd), static_cast<float*>(db), CO, H * W, gain,
      clamp, has_clamp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_of(H, W), (CI + TILE_M - 1) / TILE_M, N);
  modconv_dx_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(dzd), static_cast<const float*>(wtt),
      static_cast<const float*>(s), static_cast<const float*>(x),
      static_cast<float*>(dx), static_cast<float*>(ds_part), CI, CO, H, W);
  return static_cast<int>(cudaGetLastError());
}
