// The fused modulated synthesis layer, backward to the weight (the direct
// term), float32:
//
//   dW[co,ci,t] = sum_n sum_px (dz[n,co,px] * d[n,co]) * (x[n,ci,px+off_t] * s[n,ci])
//
// with dz = dy * g(y), the lrelu/clamp gradient rebuilt from the output y;
// the wrapper adds the demodulation's term 2 w (s^2)^T dsig.
//
// Replaces the TPU kernel stylemc_tpu/ops/pallas/modconv_pallas.py,
// functions _bwd_weight_kernel / _bwd_weight_call. Same function: the TPU
// kernel scales each sample's [CO,CI] contribution by d[n,co] * s[n,ci];
// here dz is scaled by d and x by s as they are staged, inside the per-n
// sum all the same. The TPU kernel accumulates dW across its sequential
// (n, row tile) grid; blocks here run in no order, so the (n, pixel)
// reduction is split across blocks into partials [splits][CO][CI][9] that
// the wrapper sums in a fixed order: deterministic, no atomics. The
// wrapper calls it only when the weight needs a gradient (find_direction
// and serving never pay for it).
//
// What bounds it on an H100: operations. 2*N*CO*CI*9*H*W flops, as the
// forward, for dy, y and x read once and dW written once: 1.15 ms at
// 67 TFLOP/s for FFHQ-256's 256x256 conv1 at batch 4.
//
// Design: one block per (64 CO x 64 CI tile, split of the (n, 4x16 pixel
// tile) chunks), 256 threads, each with a 4 CO x 4 CI x 9 tap register
// tile. A chunk stages dz*d [4][16][64 co] and the haloed x*s [6][18][64 ci]
// in shared memory, channels innermost (padded by 4 against bank conflicts
// on the staging writes), so a thread's 4 channels are one float4. Along a
// row, each thread keeps a 3x3 window of x float4s in registers and loads
// one new column (3 float4s) and one dz float4 per pixel for 144 FMAs. The
// number of splits fills the card's SMs once: floor(SMs / CO-CI tiles).

#include "modconv_common.cuh"

namespace {

using namespace modconv;

constexpr int WT_THREADS = 256;
constexpr int TC = 64;              // CO and CI of a block tile
constexpr int PR = 4;               // pixel chunk rows
constexpr int PW = 16;              // pixel chunk columns
constexpr int CPAD = TC + 4;        // channel stride in shared memory

__global__ void __launch_bounds__(WT_THREADS, 1)
modconv_dw_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                  const float* __restrict__ x, const float* __restrict__ s,
                  const float* __restrict__ d, float* __restrict__ partial,
                  int N, int CI, int CO, int H, int W, float gain, float clamp,
                  int has_clamp) {
  __shared__ __align__(16) float dzs[PR * PW * CPAD];
  __shared__ __align__(16) float xs[(PR + 2) * (PW + 2) * CPAD];
  const int tid = threadIdx.x;
  const int cog = tid / 16;                 // co 4*cog .. 4*cog+3 of the tile
  const int cig = tid % 16;                 // ci 4*cig .. 4*cig+3
  const int co0 = blockIdx.x * TC;
  const int ci0 = blockIdx.y * TC;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int rows = (H + PR - 1) / PR;
  const int cols = (W + PW - 1) / PW;
  const long long units = static_cast<long long>(N) * rows * cols;
  const long long u_begin = units * split / splits;
  const long long u_end = units * (split + 1) / splits;
  const long long plane = static_cast<long long>(H) * W;

  float acc[4][4][9];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[a][b][t] = 0.0f;

  for (long long u = u_begin; u < u_end; ++u) {
    const int n = static_cast<int>(u / (rows * cols));
    const int rc = static_cast<int>(u % (rows * cols));
    const int i0 = (rc / cols) * PR;
    const int j0 = (rc % cols) * PW;

    for (int idx = tid; idx < TC * PR * PW; idx += WT_THREADS) {
      const int pc = idx % (PR * PW);
      const int cl = idx / (PR * PW);
      const int co = co0 + cl;
      const int gi = i0 + pc / PW;
      const int gj = j0 + pc % PW;
      float v = 0.0f;
      if (co < CO && gi < H && gj < W) {
        const long long q = static_cast<long long>(n) * CO + co;
        const long long off = q * plane + static_cast<long long>(gi) * W + gj;
        v = __ldg(dy + off) * act_grad(__ldg(y + off), gain, clamp, has_clamp) *
            __ldg(d + q);
      }
      dzs[pc * CPAD + cl] = v;
    }
    for (int idx = tid; idx < TC * (PR + 2) * (PW + 2); idx += WT_THREADS) {
      const int pc = idx % ((PR + 2) * (PW + 2));
      const int cl = idx / ((PR + 2) * (PW + 2));
      const int ci = ci0 + cl;
      const int gi = i0 + pc / (PW + 2) - 1;
      const int gj = j0 + pc % (PW + 2) - 1;
      float v = 0.0f;
      if (ci < CI && gi >= 0 && gi < H && gj >= 0 && gj < W) {
        const long long q = static_cast<long long>(n) * CI + ci;
        v = __ldg(x + q * plane + static_cast<long long>(gi) * W + gj) * __ldg(s + q);
      }
      xs[pc * CPAD + cl] = v;
    }
    __syncthreads();

    for (int r = 0; r < PR; ++r) {
      float4 win[3][3];
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          win[di][c] = *reinterpret_cast<const float4*>(
              xs + ((r + di) * (PW + 2) + c) * CPAD + cig * 4);
#pragma unroll
      for (int j = 0; j < PW; ++j) {
#pragma unroll
        for (int di = 0; di < 3; ++di)
          win[di][2] = *reinterpret_cast<const float4*>(
              xs + ((r + di) * (PW + 2) + j + 2) * CPAD + cig * 4);
        const float4 dz4 = *reinterpret_cast<const float4*>(
            dzs + (r * PW + j) * CPAD + cog * 4);
        const float dz[4] = {dz4.x, dz4.y, dz4.z, dz4.w};
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const float xv[4] = {win[di][dj].x, win[di][dj].y, win[di][dj].z,
                                 win[di][dj].w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                acc[a][b][di * 3 + dj] = fmaf(dz[a], xv[b], acc[a][b][di * 3 + dj]);
          }
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          win[di][0] = win[di][1];
          win[di][1] = win[di][2];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int co = co0 + cog * 4 + a;
    if (co >= CO) break;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int ci = ci0 + cig * 4 + b;
      if (ci < CI) {
        float* out = partial + ((static_cast<long long>(split) * CO + co) * CI + ci) * 9;
#pragma unroll
        for (int t = 0; t < 9; ++t) out[t] = acc[a][b][t];
      }
    }
  }
}

int grid_xy(int CI, int CO) {
  return ((CO + TC - 1) / TC) * ((CI + TC - 1) / TC);
}

}  // namespace

// The number of splits of the (n, pixel) reduction for these shapes on the
// current device: the first extent of the partials that
// stylemc_modconv_bwd_weight writes. Negative on a CUDA error.
extern "C" int stylemc_modconv_bwd_weight_splits(int N, int CI, int CO, int H,
                                                 int W) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long units = static_cast<long long>(N) * ((H + PR - 1) / PR) *
                          ((W + PW - 1) / PW);
  long long splits = sms / grid_xy(CI, CO);
  if (splits < 1) splits = 1;
  if (splits > units) splits = units;
  return static_cast<int>(splits);
}

// dy, y [N,CO,H,W], x [N,CI,H,W], s [N,CI], d [N,CO] -> partial
// [splits,CO,CI,9], whose sum over the first axis is dW's direct term
// [CO,CI,3,3]. All float32, contiguous, on the current device. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int stylemc_modconv_bwd_weight(const void* dy, const void* y,
                                          const void* x, const void* s,
                                          const void* d, void* partial, int N,
                                          int CI, int CO, int H, int W,
                                          float gain, float clamp,
                                          int has_clamp, int splits,
                                          void* stream) {
  if (N <= 0 || CI <= 0 || CO <= 0 || H <= 0 || W <= 0 || splits <= 0) return 0;
  const dim3 grid((CO + TC - 1) / TC, (CI + TC - 1) / TC, splits);
  modconv_dw_kernel<<<grid, WT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y),
      static_cast<const float*>(x), static_cast<const float*>(s),
      static_cast<const float*>(d), static_cast<float*>(partial), N, CI, CO,
      H, W, gain, clamp, has_clamp);
  return static_cast<int>(cudaGetLastError());
}
