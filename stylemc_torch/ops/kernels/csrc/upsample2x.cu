// 2x FIR upsample of float32 NCHW planes: the ToRGB skip chain of the
// StyleGAN2 synthesis network (B1).
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
// What bounds it on an H100. Each input element is read once (4 B) and
// yields one 2x2 output quad (16 B) for about 12 flops, far below the
// card's flops-per-byte ratio, so bytes bound the large planes: at batch 16
// the 128^2 -> 256^2 call moves 3.1 MB in and 12.6 MB out, 4.69 us at 3.35
// TB/s, and 512^2 -> 1024^2 at batch 1 moves 15.7 MB. The chain's smaller
// planes move under 4 MB each (under 1.2 us), down to 3 kB at 4^2, so there
// the cost of one launch bounds it (launch_floor_ms in chip_smoke.py,
// measured with stylemc_torch/bench/launch_floor.cu). The design keeps the
// index work off the path of a tiny call and the bytes in flight for a
// large one.
//
// Design. The wrapper's plan (resample2x.cuh) sets a 3-D block and grid:
// blockIdx.z and threadIdx.z select the plane, the rest the column pair and
// the row strip, so no division runs on the per-element path; offsets
// inside a plane are 32-bit, with one 64-bit plane base a thread. Each
// thread owns input columns j and j+1 (j = 2*pair) and walks ROWS input
// rows, one on planes of at most 16 rows and two above (the plan's choice,
// measured on the H100). It loads every input row it needs (ROWS + 2) as
// one aligned float2, all before its first FMA, so the 128^2 call keeps
// 6.3 MB of loads in flight. Its window x[r-1 .. r+1][j-1 .. j+2] stays in
// registers: the halo columns j-1 and j+2 come from the neighbouring lanes
// by __shfl_up_sync / __shfl_down_sync, and only the lanes at a segment's
// edge load them directly. The halo is one column wide, so neither shared
// memory nor a barrier is needed. Each of a thread's two output rows per
// input row is one 16-byte float4 store of four output columns, and a warp
// of 32 pairs writes 512 contiguous bytes a row. Odd widths and misaligned
// pointers take the scalar path (VEC = false): the same walk with 4-byte
// loads and stores, each column checked. Every sum rounds in the fixed
// order of taps2 (resample2x.cuh).

#include "resample2x.cuh"

namespace {

using resample2x::FULL_WARP;
using resample2x::Taps;
using resample2x::taps2;

template <int ROWS, bool VEC>
__global__ void __launch_bounds__(resample2x::THREADS)
upsample2x_kernel(const float* __restrict__ x, float* __restrict__ y,
                  int planes, int h, int w, Taps g) {
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  const int strip = blockIdx.y * blockDim.y + threadIdx.y;
  const int plane = blockIdx.z * blockDim.z + threadIdx.z;
  const int j = 2 * pair;
  const int r0 = strip * ROWS;
  const bool live = j < w && r0 < h && plane < planes;
  const bool first = threadIdx.x == 0;               // left edge of a segment
  const bool last = threadIdx.x == blockDim.x - 1;   // right edge
  const float* xp = x + static_cast<long long>(live ? plane : 0) * (h * w);

  // window rows r0-1 .. r0+ROWS: columns j, j+1 (c), j-1 (l), j+2 (r);
  // zero outside the plane, and for a thread past its edge
  float2 c[ROWS + 2];
  float l[ROWS + 2], r[ROWS + 2];
#pragma unroll
  for (int k = 0; k < ROWS + 2; ++k) {
    const int row = r0 - 1 + k;
    const bool ok = live && row >= 0 && row < h;
    const float* xr = xp + (ok ? row * w : 0);
    if (VEC) {
      c[k] = ok ? __ldg(reinterpret_cast<const float2*>(xr + j))
                : make_float2(0.0f, 0.0f);
    } else {
      c[k].x = ok ? __ldg(xr + j) : 0.0f;
      c[k].y = ok && j + 1 < w ? __ldg(xr + j + 1) : 0.0f;
    }
    l[k] = ok && first && j > 0 ? __ldg(xr + j - 1) : 0.0f;
    r[k] = ok && last && j + 2 < w ? __ldg(xr + j + 2) : 0.0f;
  }
  // the halo from the neighbouring column pairs; every lane of the warp
  // takes part, live or not
#pragma unroll
  for (int k = 0; k < ROWS + 2; ++k) {
    const float from_left = __shfl_up_sync(FULL_WARP, c[k].y, 1);
    const float from_right = __shfl_down_sync(FULL_WARP, c[k].x, 1);
    if (!first) l[k] = from_left;
    if (!last) r[k] = from_right;
  }
  if (!live) return;

  const int w2 = 2 * w;
  float* yp = y + static_cast<long long>(plane) * (4 * h * w);
#pragma unroll
  for (int k = 1; k <= ROWS; ++k) {
    const int row = r0 + k - 1;
    if (row >= h) break;
    // vertical pass over columns j-1 .. j+2: output rows 2*row (e), 2*row+1 (o)
    const float u[4] = {l[k - 1], c[k - 1].x, c[k - 1].y, r[k - 1]};
    const float m[4] = {l[k], c[k].x, c[k].y, r[k]};
    const float d[4] = {l[k + 1], c[k + 1].x, c[k + 1].y, r[k + 1]};
    float e[4], o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = taps2(g.g0, u[i], g.g2, m[i]);
      o[i] = taps2(g.g1, m[i], g.g3, d[i]);
    }
    // horizontal pass: output columns 2j .. 2j+3
    const float4 top = make_float4(taps2(g.g0, e[0], g.g2, e[1]),
                                   taps2(g.g1, e[1], g.g3, e[2]),
                                   taps2(g.g0, e[1], g.g2, e[2]),
                                   taps2(g.g1, e[2], g.g3, e[3]));
    const float4 bot = make_float4(taps2(g.g0, o[0], g.g2, o[1]),
                                   taps2(g.g1, o[1], g.g3, o[2]),
                                   taps2(g.g0, o[1], g.g2, o[2]),
                                   taps2(g.g1, o[2], g.g3, o[3]));
    float* out = yp + 2 * row * w2 + 2 * j;
    if (VEC) {
      *reinterpret_cast<float4*>(out) = top;
      *reinterpret_cast<float4*>(out + w2) = bot;
    } else {
      out[0] = top.x;
      out[1] = top.y;
      out[w2] = bot.x;
      out[w2 + 1] = bot.y;
      if (j + 1 < w) {
        out[2] = top.z;
        out[3] = top.w;
        out[w2 + 2] = bot.z;
        out[w2 + 3] = bot.w;
      }
    }
  }
}

template <int ROWS>
void launch(dim3 grid, dim3 block, cudaStream_t st, int vec,
            const float* x, float* y, int planes, int h, int w, Taps g) {
  if (vec)
    upsample2x_kernel<ROWS, true><<<grid, block, 0, st>>>(x, y, planes, h, w,
                                                      g);
  else
    upsample2x_kernel<ROWS, false><<<grid, block, 0, st>>>(x, y, planes, h, w,
                                                       g);
}

}  // namespace

// x: [planes, h, w] float32, y: [planes, 2h, 2w] float32, both contiguous
// on the current device; the plan as upsample_plan computes it (rows, block
// tx x ty x ps, grid gx x gy x gz) and vec for the float2/float4 path.
// Launches on `stream` and returns cudaGetLastError(), or PLAN_REFUSED
// (before launching anything) for a plan that does not fit.
extern "C" int stylemc_upsample2x(const void* x, void* y, long long planes,
                                  int h, int w, float g0, float g1, float g2,
                                  float g3, int rows, int tx, int ty, int ps,
                                  int gx, int gy, int gz, int vec,
                                  void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  const int err = resample2x::check_plan(planes, h, w, rows, tx, ty, ps, gx,
                                         gy, gz, vec, x, 8, y, 16);
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
