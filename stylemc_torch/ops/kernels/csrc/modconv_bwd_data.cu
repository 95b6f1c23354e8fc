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
// order, so each sum is owned by one block or written as partials that a
// later launch sums in a fixed order: the results are deterministic, no
// atomics.
//
// What bounds it on an H100: operations. The transposed convolution is
// 2*N*CI*CO*9*H*W flops, as the forward, done on the tensor cores in
// 3xTF32 (tests/test_torch_modconv_bwd_data_tc.py emulates it and one
// TF32 pass): 1.5624 ms summed over FFHQ-256's seven conv1 layers at batch
// 4, the bytes (dy, y, x read and dx written once, 16 bytes per element of
// a plane, and the weight) far below it but at 4x4, where the 9.4 MB
// weight bounds it.
//
// Design: up to four launches, counted as one call by the wrapper.
//  1. modconv_dz_kernel, one block per (n, co) plane: one pass over dy and
//     y writes dz to a scratch plane and reduces sum dz, sum dz*z1 and
//     sum dz*noise in a fixed order (warp shuffles, then the 8 warps in
//     turn), from which it writes db and dd.
//  2. split_w_kernel<true> (modconv_igemm.cuh): w split into (big, small)
//     TF32 pairs laid out per 64-channel CI tile as [CO_pad][9][68], entry
//     [co][3*di+dj][ci] the split of w[co][ci][2-di][2-dj], read from w
//     itself.
//  3. igemm_kernel (modconv_igemm.cuh, B3's mainloop) with M = CI, K = CO,
//     the input dz and its per-K scale d[n,co], applied in registers as
//     B3 applies s: 3xTF32 on mma.sync, fragments restarted per 8-channel
//     chunk. Its epilogue (DxEpilogue) writes dx = acc * s[n,ci] once and
//     sums acc * x[n,ci,px] over its pixel chunk in a fixed order
//     (registers, a fragment's four t lanes by shuffles, then the block's
//     four pixel groups in turn through shared memory) into partials
//     [N,CI,chunks]. Where the plan (modconv.py, fwd_plan with CI and CO
//     swapped) splits CO over blocks, at 4x4 to 16x16, it writes raw
//     partials [splits,N,CI,H,W] instead.
//  4. One reduction: modconv_ds_reduce_kernel sums the chunks' ds
//     partials in chunk order, or, split, modconv_dx_reduce_kernel sums the
//     split partials in split order and writes dx and ds_direct, one block
//     per (n, ci) plane.
// The dz scratch round trip costs 8 bytes per element of the CO planes, a
// few percent of the convolution's time at every conv1 shape.

#include "modconv_common.cuh"
#include "modconv_igemm.cuh"
#include "modconv_tc.cuh"

namespace {

using modconv::act_grad;
using modconv::LRELU_SLOPE;
using namespace modconv_igemm;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of v over the block: warp shuffles, then the warps in turn;
// the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[THREADS / 32];
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(THREADS)
modconv_dz_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                  const float* __restrict__ d, const float* __restrict__ noise,
                  const float* __restrict__ bias, float* __restrict__ dz,
                  float* __restrict__ dd, float* __restrict__ db, int CO,
                  int plane, float gain, float clamp, int has_clamp) {
  __shared__ float red[THREADS / 32][3];
  const long long q = blockIdx.x;                 // n * CO + co
  const int co = static_cast<int>(q % CO);
  const long long base = q * plane;
  float s_dz = 0.0f, s_t1 = 0.0f, s_t3 = 0.0f;
  for (int p = threadIdx.x; p < plane; p += THREADS) {
    const float yv = __ldg(y + base + p);
    const float g = __ldg(dy + base + p) * act_grad(yv, gain, clamp, has_clamp);
    dz[base + p] = g;
    const float a = yv / gain;
    const float z1 = a >= 0.0f ? a : a / LRELU_SLOPE;
    s_dz += g;
    s_t1 += g * z1;
    s_t3 += g * __ldg(noise + p);
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
    dd[q] = (t1 - __ldg(bias + co) * t0 - t3) / __ldg(d + q);
  }
}

// B4's epilogue of igemm_kernel (rows are input channels). Unsplit
// (gridDim.z == 1) it writes dx = acc * s and the block's sum of acc * x
// per channel to ds_part [N,CI,chunks of a plane]; split, the raw sums to
// out = partial [splits,N,CI,H,W].
struct DxEpilogue {
  const float* s;    // [N, CI]
  const float* x;    // [N, CI, H, W]
  float* out;        // dx, or the split partials
  float* ds_part;
  int N;

  template <int NT>
  __device__ __forceinline__ void operator()(const float (&acc)[MT][NT][4],
                                             const Block& b, int CI, int H,
                                             int W,
                                             int chunks_per_plane) const {
    __shared__ float red[PX_GROUPS][BM];
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long plane = static_cast<long long>(H) * W;
    const bool unsplit = gridDim.z == 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = b.wm * WM + mt * 16 + g + 8 * hf;   // in the tile
        const int ci = b.m0 + row;
        float part = 0.0f;
        if (b.active && ci < CI) {
          const long long nci = static_cast<long long>(b.tl.n) * CI + ci;
          const float sm = unsplit ? __ldg(s + nci) : 1.0f;
          const float* xrow = x + nci * plane;
          float* orow =
              out + (static_cast<long long>(blockIdx.z) * N * CI + nci) * plane;
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
              if (unsplit) {
                orow[p] = v * sm;
                part += v * __ldg(xrow + p);
              } else {
                orow[p] = v;
              }
            }
          }
        }
        if (unsplit) {
          // the four t lanes of fragment row g, then the pixel groups
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          if (t == 0) red[b.pg][row] = part;
        }
      }
    }
    if (!unsplit) return;
    __syncthreads();
    const int ci = b.m0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < BM && ci < CI) {
      float sum = 0.0f;
#pragma unroll
      for (int pg = 0; pg < PX_GROUPS; ++pg) sum += red[pg][threadIdx.x];
      ds_part[(static_cast<long long>(b.tl.n) * CI + ci) * chunks_per_plane +
              b.rc] = sum;
    }
  }
};

// ds[r] = the sum of ds_part [rows, chunks] over its chunks, in order.
__global__ void modconv_ds_reduce_kernel(const float* __restrict__ ds_part,
                                         float* __restrict__ ds,
                                         long long rows, int chunks) {
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       r < rows; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.0f;
    for (int c = 0; c < chunks; ++c) sum += ds_part[r * chunks + c];
    ds[r] = sum;
  }
}

// One block per (n, ci) plane: dxmod = the sum over splits of partial
// [splits,N,CI,H,W] in split order, dx = dxmod * s[n,ci] and
// ds[n,ci] = sum_px dxmod * x (block_sum's order).
__global__ void __launch_bounds__(THREADS)
modconv_dx_reduce_kernel(const float* __restrict__ partial,
                         const float* __restrict__ s,
                         const float* __restrict__ x, float* __restrict__ dx,
                         float* __restrict__ ds, long long total, int plane,
                         int splits) {
  const long long q = blockIdx.x;                 // n * CI + ci
  const float sm = __ldg(s + q);
  float part = 0.0f;
  for (int p = threadIdx.x; p < plane; p += THREADS) {
    const long long idx = q * plane + p;
    float sum = 0.0f;
    for (int z = 0; z < splits; ++z) sum += partial[z * total + idx];
    dx[idx] = sum * sm;
    part += sum * __ldg(x + idx);
  }
  const float sum = block_sum(part);
  if (threadIdx.x == 0) ds[q] = sum;
}

}  // namespace

// dy, y [N,CO,H,W], x [N,CI,H,W], w [CO,CI,3,3], s [N,CI], d [N,CO],
// noise [H,W], bias [CO]; scratch dz [N,CO,H,W] (16-byte aligned), wsplit
// (16-byte aligned, CI_pad/64 * CO_pad*9*68*2 floats; CI_pad = CI rounded
// up to 64, CO_pad = CO rounded up to 8), partial [splits,N,CI,H,W] when
// splits > 1 or ds_part [N,CI,chunks of a plane] when splits == 1 (the
// other unused); out dx [N,CI,H,W], ds [N,CI], dd [N,CO], db [N,CO]. All
// float32, contiguous, on the current device. splits and chunk_cols (8 or
// 16) come from the wrapper's plan; vec != 0 promises W % 4 == 0. Four
// launches on `stream`; returns the first CUDA error code (0 on success).
extern "C" int stylemc_modconv_bwd_data(
    const void* dy, const void* y, const void* x, const void* w,
    const void* s, const void* d, const void* noise, const void* bias,
    void* dz, void* wsplit, void* partial, void* ds_part, void* dx, void* ds,
    void* dd, void* db, int N, int CI, int CO, int H, int W, float gain,
    float clamp, int has_clamp, int splits, int chunk_cols, int vec,
    void* stream) {
  if (N <= 0 || CI <= 0 || CO <= 0 || H <= 0 || W <= 0 || splits <= 0)
    return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  modconv_dz_kernel<<<static_cast<unsigned int>(N) * CO, THREADS, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y),
      static_cast<const float*>(d), static_cast<const float*>(noise),
      static_cast<const float*>(bias), static_cast<float*>(dz),
      static_cast<float*>(dd), static_cast<float*>(db), CO, H * W, gain,
      clamp, has_clamp);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  float* ws = static_cast<float*>(wsplit);
  err = split_w<true>(static_cast<const float*>(w), ws, CO, CI, st);
  if (err != 0) return err;
  const DxEpilogue epi{static_cast<const float*>(s),
                       static_cast<const float*>(x),
                       static_cast<float*>(splits > 1 ? partial : dx),
                       static_cast<float*>(ds_part), N};
  err = launch_igemm(static_cast<const float*>(dz), ws,
                     static_cast<const float*>(d), N, CO, CI, H, W, splits,
                     chunk_cols, vec, epi, st);
  if (err != 0) return err;
  const long long rows = static_cast<long long>(N) * CI;
  if (splits == 1) {
    const int pw = chunk_cols;
    const int chunks = ((H + PR - 1) / PR) * ((W + pw - 1) / pw);
    modconv_ds_reduce_kernel<<<grid_for(rows), THREADS, 0, st>>>(
        static_cast<const float*>(ds_part), static_cast<float*>(ds), rows,
        chunks);
  } else {
    modconv_dx_reduce_kernel<<<static_cast<unsigned int>(rows), THREADS, 0,
                               st>>>(
        static_cast<const float*>(partial), static_cast<const float*>(s),
        static_cast<const float*>(x), static_cast<float*>(dx),
        static_cast<float*>(ds), rows * H * W, H * W, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
