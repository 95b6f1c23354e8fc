// 2x FIR downsample of float32 NCHW planes: the backward pass of the ToRGB
// skip chain's upsample (and the op downsample2d with a 4-tap filter) (B2).
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
// transposes.
//
// What bounds it on an H100. Device memory sees each input element once
// (16 B per output) and each output once (4 B), for 24 flops per output in
// the separable form, so bytes bound a large plane: [4,3,256,256] in and
// [4,3,128,128] out, the largest shape of a training step's backward, move
// 3.9 MB, 1.17 us at 3.35 TB/s, and the 1024^2 plane at batch 1 moves 15.7
// MB. Every other training shape moves under 1 MB (under 0.3 us), so there
// the cost of one launch bounds it (launch_floor_ms in chip_smoke.py,
// measured with stylemc_torch/bench/launch_floor.cu).
//
// Design, B1's scheme (upsample2x.cu) in the separable form. The wrapper's
// plan (resample2x.cuh) sets a 3-D block and grid over (output column
// pairs, output row strips, planes): no division on the per-element path,
// 32-bit offsets inside a plane, one 64-bit plane base a thread. Each thread
// owns output columns q and q+1 (q = 2*pair), that is input columns 4*pair
// .. 4*pair+3, read as one aligned float4 a row, and walks ROWS output
// rows, one on output planes of at most 16 rows and two above (the plan's
// choice, measured on the H100): 2*ROWS + 2 input rows, all loaded before
// its first FMA (64 or 96 B in flight a thread). Each output row takes two
// new input rows and carries the two it shares with the row before. The
// vertical pass runs on the thread's four columns; the halo columns
// 4*pair-1 and 4*pair+4 arrive after it, as the neighbouring lanes'
// vertical sums by __shfl_up_sync / __shfl_down_sync (one shuffle each way
// an output row), and only the lanes at a segment's edge load them and sum
// them themselves. No shared memory, no barrier. The horizontal pass then
// gives both outputs, stored as one float2. Odd output widths and
// misaligned pointers take the scalar path (VEC = false): the same walk
// with 4-byte loads and stores. Every sum rounds in the fixed order of
// taps4 (resample2x.cuh).

#include "resample2x.cuh"

namespace {

using resample2x::FULL_WARP;
using resample2x::Taps;
using resample2x::taps4;

template <int ROWS, bool VEC>
__global__ void __launch_bounds__(resample2x::THREADS)
downsample2x_kernel(const float* __restrict__ x, float* __restrict__ y,
                    int planes, int h, int w, Taps g) {
  constexpr int IN_ROWS = 2 * ROWS + 2;
  // h, w: the output plane; the input plane is 2h x 2w
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  const int strip = blockIdx.y * blockDim.y + threadIdx.y;
  const int plane = blockIdx.z * blockDim.z + threadIdx.z;
  const int q = 2 * pair;        // first output column
  const int c0 = 2 * q;          // first input column
  const int m0 = strip * ROWS;   // first output row
  const int hi = 2 * h, wi = 2 * w;
  const bool live = q < w && m0 < h && plane < planes;
  const bool first = threadIdx.x == 0;
  const bool last = threadIdx.x == blockDim.x - 1;
  const float* xp = x + static_cast<long long>(live ? plane : 0) * (hi * wi);

  // input rows 2*m0-1 .. 2*m0+2*ROWS: columns c0 .. c0+3 (c), c0-1 (l),
  // c0+4 (r); zero outside the plane and for a thread past its edge
  float4 c[IN_ROWS];
  float l[IN_ROWS], r[IN_ROWS];
#pragma unroll
  for (int k = 0; k < IN_ROWS; ++k) {
    const int row = 2 * m0 - 1 + k;
    const bool ok = live && row >= 0 && row < hi;
    const float* xr = xp + (ok ? row * wi : 0);
    if (VEC) {
      c[k] = ok ? __ldg(reinterpret_cast<const float4*>(xr + c0))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      c[k].x = ok ? __ldg(xr + c0) : 0.0f;
      c[k].y = ok && c0 + 1 < wi ? __ldg(xr + c0 + 1) : 0.0f;
      c[k].z = ok && c0 + 2 < wi ? __ldg(xr + c0 + 2) : 0.0f;
      c[k].w = ok && c0 + 3 < wi ? __ldg(xr + c0 + 3) : 0.0f;
    }
    l[k] = ok && first && c0 > 0 ? __ldg(xr + c0 - 1) : 0.0f;
    r[k] = ok && last && c0 + 4 < wi ? __ldg(xr + c0 + 4) : 0.0f;
  }
  // vertical pass: output row m0+i sums input rows 2i .. 2i+3 of the window
  float4 v[ROWS];
  float vl[ROWS], vr[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float4 a = c[2 * i], b = c[2 * i + 1], cc = c[2 * i + 2],
                 d = c[2 * i + 3];
    v[i] = make_float4(taps4(g, a.x, b.x, cc.x, d.x),
                       taps4(g, a.y, b.y, cc.y, d.y),
                       taps4(g, a.z, b.z, cc.z, d.z),
                       taps4(g, a.w, b.w, cc.w, d.w));
    vl[i] = taps4(g, l[2 * i], l[2 * i + 1], l[2 * i + 2], l[2 * i + 3]);
    vr[i] = taps4(g, r[2 * i], r[2 * i + 1], r[2 * i + 2], r[2 * i + 3]);
  }
  // the halo columns' vertical sums from the neighbouring column pairs;
  // every lane of the warp takes part, live or not
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float from_left = __shfl_up_sync(FULL_WARP, v[i].w, 1);
    const float from_right = __shfl_down_sync(FULL_WARP, v[i].x, 1);
    if (!first) vl[i] = from_left;
    if (!last) vr[i] = from_right;
  }
  if (!live) return;

  float* yp = y + static_cast<long long>(plane) * (h * w);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = m0 + i;
    if (row >= h) break;
    // horizontal pass: output q sums input columns c0-1 .. c0+2, q+1
    // sums c0+1 .. c0+4
    const float2 out =
        make_float2(taps4(g, vl[i], v[i].x, v[i].y, v[i].z),
                    taps4(g, v[i].y, v[i].z, v[i].w, vr[i]));
    float* o = yp + row * w + q;
    if (VEC) {
      *reinterpret_cast<float2*>(o) = out;
    } else {
      o[0] = out.x;
      if (q + 1 < w) o[1] = out.y;
    }
  }
}

template <int ROWS>
void launch(dim3 grid, dim3 block, cudaStream_t st, int vec,
            const float* x, float* y, int planes, int h, int w, Taps g) {
  if (vec)
    downsample2x_kernel<ROWS, true><<<grid, block, 0, st>>>(x, y, planes, h, w,
                                                      g);
  else
    downsample2x_kernel<ROWS, false><<<grid, block, 0, st>>>(x, y, planes, h, w,
                                                       g);
}

}  // namespace

// x: [planes, 2h, 2w] float32, y: [planes, h, w] float32, both contiguous
// on the current device; the plan as downsample_plan computes it (rows,
// block tx x ty x ps, grid gx x gy x gz) and vec for the float4/float2
// path. Launches on `stream` and returns cudaGetLastError(), or
// PLAN_REFUSED (before launching anything) for a plan that does not fit.
extern "C" int stylemc_downsample2x(const void* x, void* y, long long planes,
                                    int h, int w, float g0, float g1,
                                    float g2, float g3, int rows, int tx,
                                    int ty, int ps, int gx, int gy, int gz,
                                    int vec, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  const int err = resample2x::check_plan(planes, h, w, rows, tx, ty, ps, gx,
                                         gy, gz, vec, x, 16, y, 8);
  if (err != 0) return err;
  const dim3 grid(gx, gy, gz), block(tx, ty, ps);
  const auto st = static_cast<cudaStream_t>(stream);
  const Taps g{g0, g1, g2, g3};
  const auto* xs = static_cast<const float*>(x);
  auto* ys = static_cast<float*>(y);
  const int n = static_cast<int>(planes);
  switch (rows) {   // the rows a thread walks, as the plan sets them
    case 1: launch<1>(grid, block, st, vec, xs, ys, n, h, w, g); break;
    case 2: launch<2>(grid, block, st, vec, xs, ys, n, h, w, g); break;
    default: return resample2x::PLAN_REFUSED;
  }
  return static_cast<int>(cudaGetLastError());
}
