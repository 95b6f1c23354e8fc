// The fused modulated synthesis layer, forward (up 1, 3x3, pad 1), float32
// in and out:
//
//   y[n,co,p] = clamp(lrelu(d[n,co] * sum_ci sum_t w[co,ci,t] * s[n,ci]
//                           * x[n,ci,p + off_t] + noise[p] + b[co]) * gain)
//
// with d = rsqrt(s^2 . sum_t w^2 + 1e-8) computed by the wrapper.
//
// Replaces the TPU kernel stylemc_tpu/ops/pallas/modconv_pallas.py,
// functions _fwd_kernel / _fwd_call. Same function: the TPU kernel folds s
// and d into the nine taps and contracts [CO,CI] x [CI,(TH+2)*W] windows on
// the MXU; here s scales the input as its fragments are read and d scales
// the sum in the epilogue, which reassociates the products (the tests'
// tolerance covers it). The [N,C,H*W] lane layout, the column rolls and the
// 128-lane alignment of the TPU kernel are not carried over: any plane size
// works, 4x4 included.
//
// What bounds it on an H100: operations. An implicit GEMM with M = CO,
// N = (n, pixel) and K = CI x 9 taps, 2*N*CO*CI*9*H*W flops, done on the
// tensor cores in 3xTF32 (three TF32 products per fp32 product, which keeps
// fp32's accuracy where one TF32 pass misses B3's gate;
// tests/test_torch_modconv_fwd_tc.py emulates both): 3x the flops at 495
// TFLOP/s, 1.5623 ms summed over FFHQ-256's seven conv1 layers at batch 4.
// At 4x4 the bytes bound it instead: the [512,512,3,3] weight (9.4 MB)
// against 0.3 GFLOP. mma.sync, the route taken here, runs near 300 TFLOP/s
// of TF32 on the card (stylemc_torch/bench/mma_rate.py), so 3xTF32 through
// it tops out near 100 TFLOP/s; wgmma, not taken (its swizzled operands
// cannot be read at the nine one-pixel tap offsets without a re-layout),
// reaches 495.
//
// Design: the implicit GEMM of modconv_igemm.cuh (shared with B4) with
// M = CO, K = CI, the input x and its scale s: mma.sync.m16n8k8 TF32, the
// weight split once per call into (big, small) pairs and bulk-copied a
// chunk at a time, x*s split in registers, 64 CO x a 16x16 pixel chunk a
// block, a 3-stage ring, one barrier a chunk.
// - Small planes (4x4 to 16x16) leave too few (CO tile, chunk) blocks for
//   132 SMs, so the wrapper's plan (modconv.py, fwd_plan) splits the CI
//   range over blocks: each writes fp32 partials [splits,N,CO,H,W] and a
//   third launch sums them in a fixed order (deterministic, no atomics)
//   and applies the epilogue. Unsplit, the epilogue runs in registers:
//   d[n,co], noise, bias, lrelu(0.2) * gain and the clamp, y written once.

#include <cstdint>

#include "modconv_igemm.cuh"
#include "modconv_tc.cuh"

namespace {

using namespace modconv_igemm;

constexpr float LRELU_SLOPE = 0.2f;

__device__ __forceinline__ float epilogue(float acc, float dm, float nz,
                                          float bm, float gain, float clamp,
                                          int has_clamp) {
  const float z = acc * dm + nz + bm;
  float v = (z >= 0.0f ? z : z * LRELU_SLOPE) * gain;
  if (has_clamp) v = fminf(fmaxf(v, -clamp), clamp);
  return v;
}

// B3's epilogue of igemm_kernel: with gridDim.z == 1 it writes y; else
// out is partial [splits,N,CO,H,W].
struct FwdEpilogue {
  const float* d;       // [N, CO]
  const float* noise;   // [H, W]
  const float* bias;    // [CO]
  float* out;
  int N;
  float gain, clamp;
  int has_clamp;

  template <int NT>
  __device__ __forceinline__ void operator()(const float (&acc)[MT][NT][4],
                                             const Block& b, int CO, int H,
                                             int W, int) const {
    if (!b.active) return;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long plane = static_cast<long long>(H) * W;
    const bool unsplit = gridDim.z == 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int co = b.m0 + b.wm * WM + mt * 16 + g + 8 * hf;
        if (co >= CO) continue;
        const long long nco = static_cast<long long>(b.tl.n) * CO + co;
        const float dm = unsplit ? __ldg(d + nco) : 1.0f;
        const float bm = unsplit ? __ldg(bias + co) : 0.0f;
        float* orow =
            out + (static_cast<long long>(blockIdx.z) * N * CO + nco) * plane;
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          const int i = b.tl.i0 + b.rq + q;
          if (i >= H) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = b.tl.j0 + b.cq + 2 * t + e;
            if (j >= W) continue;
            const float v = acc[mt][q][2 * hf + e];
            const long long p = static_cast<long long>(i) * W + j;
            orow[p] = unsplit ? epilogue(v, dm, __ldg(noise + p), bm, gain,
                                         clamp, has_clamp)
                              : v;
          }
        }
      }
    }
  }
};

// y = the epilogue of the sum over splits of partial [splits,N,CO,H,W],
// taken in split order.
__global__ void modconv_fwd_reduce_kernel(
    const float* __restrict__ partial, const float* __restrict__ d,
    const float* __restrict__ noise, const float* __restrict__ bias,
    float* __restrict__ y, int N, int CO, int H, int W, int splits,
    float gain, float clamp, int has_clamp) {
  const long long plane = static_cast<long long>(H) * W;
  const long long total = static_cast<long long>(N) * CO * plane;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.0f;
    for (int z = 0; z < splits; ++z) sum += partial[z * total + idx];
    const long long nco = idx / plane;
    y[idx] = epilogue(sum, __ldg(d + nco), __ldg(noise + idx % plane),
                      __ldg(bias + nco % CO), gain, clamp, has_clamp);
  }
}

}  // namespace

// x [N,CI,H,W], w [CO,CI,3,3], s [N,CI], d [N,CO], noise [H,W], bias [CO]
// -> y [N,CO,H,W]; all float32, contiguous, on the current device. wsplit
// is 16-byte aligned scratch of CO_pad/64 * CI_pad*9*68*2 floats (CI_pad =
// CI rounded up to 8, CO_pad = CO rounded up to 64); partial, scratch
// [splits,N,CO,H,W] when splits > 1 (else unused). splits and chunk_cols
// (8 or 16) come from the wrapper's plan; vec != 0 promises W % 4 == 0 and
// a 16-byte aligned x. Launches the weight split, the main kernel and,
// when splits > 1, the reduction on `stream`, and returns the first CUDA
// error code (0 on success).
extern "C" int stylemc_modconv_fwd(const void* x, const void* w,
                                   const void* s, const void* d,
                                   const void* noise, const void* bias,
                                   void* wsplit, void* partial, void* y,
                                   int N, int CI, int CO, int H, int W,
                                   float gain, float clamp, int has_clamp,
                                   int splits, int chunk_cols, int vec,
                                   void* stream) {
  if (N <= 0 || CI < 0 || CO <= 0 || H <= 0 || W <= 0 || splits <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(wsplit);
  int err = split_w<false>(static_cast<const float*>(w), ws, CI, CO, st);
  if (err != 0) return err;
  const FwdEpilogue epi{static_cast<const float*>(d),
                        static_cast<const float*>(noise),
                        static_cast<const float*>(bias),
                        static_cast<float*>(splits > 1 ? partial : y),
                        N, gain, clamp, has_clamp};
  err = launch_igemm(static_cast<const float*>(x), ws,
                     static_cast<const float*>(s), N, CI, CO, H, W, splits,
                     chunk_cols, vec, epi, st);
  if (err != 0 || splits == 1) return err;
  modconv_fwd_reduce_kernel<<<grid_for(static_cast<long long>(N) * CO * H *
                                       W),
                              THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(d),
      static_cast<const float*>(noise), static_cast<const float*>(bias),
      static_cast<float*>(y), N, CO, H, W, splits, gain, clamp, has_clamp);
  return static_cast<int>(cudaGetLastError());
}
