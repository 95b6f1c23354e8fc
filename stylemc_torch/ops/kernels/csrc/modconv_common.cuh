// Shared by the fused synthesis layer's backward kernels
// (modconv_bwd_data.cu, modconv_bwd_weight.cu): the 3x3 tile convolution on
// CUDA cores that B4's transposed convolution runs, and the lrelu/clamp
// gradient rule. (B3, modconv_fwd.cu, runs on the tensor cores and no longer
// includes this header.)
//
// conv3x3_mainloop computes, for one sample n, one tile of TILE_M output
// channels and one TILE_H x TILE_W tile of the plane (pad 1, stride 1),
//
//   acc[m][p] = sum_k sum_t  wt[k][t][m] * in[n][k][p + off_t] * scale[n][k]
//
// with tap t = 3*di + dj at offset (di - 1, dj - 1). The K channels are taken
// KC at a time: the block stages the haloed input tile (scaled) and the
// [KC][9][TILE_M] weight slice in shared memory, then every thread
// accumulates an 8 x 8 register tile (8 output channels x 8 consecutive
// pixels of one row) in fp32 FMAs. A thread's 8 pixels in one row need 10
// input values per tap row, loaded once and reused by the row's three taps;
// its 8 weights per tap are two float4 loads that the whole warp shares
// (a warp's 32 threads hold one 8-channel group and the tile's 32 pixel
// groups). The weight layout [K][9][M] is prepared by the wrapper.

#pragma once

#include <cuda_runtime.h>

namespace modconv {

constexpr int THREADS = 256;
constexpr int TILE_H = 16;
constexpr int TILE_W = 16;
constexpr int TILE_M = 64;          // output channels of a block
constexpr int KC = 8;               // input channels staged at a time
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int IN_TILE = KC * HALO_H * HALO_W;
constexpr int W_TILE = KC * 9 * TILE_M;
constexpr float LRELU_SLOPE = 0.2f;

static_assert(THREADS == (TILE_M / 8) * TILE_H * (TILE_W / 8),
              "one thread per 8 channels x 8 pixels of the tile");

__host__ __device__ inline int tiles_of(int h, int w) {
  return ((h + TILE_H - 1) / TILE_H) * ((w + TILE_W - 1) / TILE_W);
}

// d(clamp(lrelu(z) * gain)) / dz, read off the output y: 0 where the clamp
// binds (|y| >= clamp), else gain or gain * 0.2 by the sign of y.
__device__ __forceinline__ float act_grad(float y, float gain, float clamp,
                                          int has_clamp) {
  if (has_clamp && fabsf(y) >= clamp) return 0.0f;
  return y >= 0.0f ? gain : gain * LRELU_SLOPE;
}

// Thread layout of the 8 x 8 register tile inside a TILE_M x (TILE_H x
// TILE_W) block tile.
struct TileCoord {
  int mg;   // 8-channel group: channels 8*mg .. 8*mg + 7 of the tile
  int r;    // row of the plane tile
  int c0;   // first of 8 consecutive columns
};

__device__ __forceinline__ TileCoord tile_coord() {
  const int tid = threadIdx.x;
  const int pg = tid % 32;
  return {tid / 32, pg / (TILE_W / 8), (pg % (TILE_W / 8)) * 8};
}

// in: [N, K, H, W]; scale: [N, K] or nullptr; wt: [K, 9, M]. The tile's
// top-left pixel is (i0, j0), its first output channel m0. Lanes outside
// the plane or past M/K read zeros.
__device__ __forceinline__ void conv3x3_mainloop(
    const float* __restrict__ in, const float* __restrict__ scale,
    const float* __restrict__ wt, int n, int K, int M, int H, int W, int m0,
    int i0, int j0, float (&acc)[8][8], float* xs, float* ws) {
  const int tid = threadIdx.x;
  const TileCoord tc = tile_coord();
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

  const long long plane = static_cast<long long>(H) * W;
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int idx = tid; idx < IN_TILE; idx += THREADS) {
      const int kl = idx / (HALO_H * HALO_W);
      const int rem = idx % (HALO_H * HALO_W);
      const int gi = i0 + rem / HALO_W - 1;
      const int gj = j0 + rem % HALO_W - 1;
      const int k = k0 + kl;
      float v = 0.0f;
      if (k < K && gi >= 0 && gi < H && gj >= 0 && gj < W) {
        v = __ldg(in + (static_cast<long long>(n) * K + k) * plane +
                  static_cast<long long>(gi) * W + gj);
        if (scale != nullptr) v *= __ldg(scale + static_cast<long long>(n) * K + k);
      }
      xs[idx] = v;
    }
    for (int idx = tid; idx < W_TILE; idx += THREADS) {
      const int ml = idx % TILE_M;
      const int kt = idx / TILE_M;          // kl * 9 + t
      const int k = k0 + kt / 9;
      const int m = m0 + ml;
      ws[idx] = (k < K && m < M)
                    ? __ldg(wt + (static_cast<long long>(k) * 9 + kt % 9) * M + m)
                    : 0.0f;
    }
    __syncthreads();

#pragma unroll 2
    for (int kl = 0; kl < KC; ++kl) {
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const float* xrow = xs + kl * HALO_H * HALO_W + (tc.r + di) * HALO_W + tc.c0;
        float xv[10];
#pragma unroll
        for (int c = 0; c < 10; ++c) xv[c] = xrow[c];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + (kl * 9 + di * 3 + dj) * TILE_M + tc.mg * 8);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(wv[a], xv[b + dj], acc[a][b]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace modconv
