// What B1 (upsample2x.cu) and B2 (downsample2x.cu) share: the 4-tap filter,
// the block size, and the check of the launch plan that the wrapper
// computes (upsample_plan / downsample_plan in ops/kernels/upfirdn2d.py).
//
// A plan names the smaller plane (h, w): B1's input, B2's output. Thread
// (pair, strip, plane) owns columns 2*pair and 2*pair+1 and `rows` rows of
// it. A block is tx column pairs x ty row strips x ps plane slots
// (threadIdx.x, .y, .z); the grid is (gx, gy, gz) tiles of those. tx is a
// power of two no larger than a warp, so each warp holds whole segments of
// tx lanes that share one row strip and plane, and a lane's shuffle
// neighbours are its neighbouring column pairs except at a segment's edge.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace resample2x {

constexpr int THREADS = 128;   // the most threads a block (RESAMPLE_THREADS)
constexpr int GRID_YZ_MAX = 65535;
constexpr unsigned FULL_WARP = 0xffffffffu;
// returned for a plan the entry refuses; the wrapper raises ValueError
constexpr int PLAN_REFUSED = -1;

struct Taps {
  float g0, g1, g2, g3;
};

// Sums of tap products as fused multiply-adds in an order the source
// fixes, not left to the compiler's contraction: ga*a + gb*b is
// fma(ga, a, gb*b), and a four-tap sum is a chain of fmas from the first
// tap, fma(g3, d, fma(g2, c, fma(g1, b, g0*a))). So every build rounds the
// same way. That matters beyond these kernels' own gate (1e-5 of the plain
// version, which rounds each product and sum apart): chip_smoke.py's
// one-step card-against-CPU parity (Δs gradient within 1e-3 relative L2)
// reads the image's last bits through ArcFace, and read 9.80e-4 with this
// rounding against 1.18e-3 with the plain version's on the H100.
__device__ __forceinline__ float taps2(float ga, float a, float gb,
                                       float b) {
  return __fmaf_rn(ga, a, __fmul_rn(gb, b));
}

__device__ __forceinline__ float taps4(const Taps& g, float a, float b,
                                       float c, float d) {
  return __fmaf_rn(g.g3, d,
                   __fmaf_rn(g.g2, c, __fmaf_rn(g.g1, b, __fmul_rn(g.g0, a))));
}

// 0 when the plan covers `planes` planes of h x w with `rows` rows a thread,
// fits CUDA's grid, whole warps of at most THREADS threads a block and the
// kernel's 32-bit offsets inside a plane (the larger plane, 4*h*w floats,
// is indexed with int), and, for the vector path, `x` is aligned to
// `x_align` bytes and `y` to `y_align`; PLAN_REFUSED otherwise. Nothing is
// clipped. Which `rows` a kernel takes is its entry's to check.
inline int check_plan(long long planes, int h, int w, int rows, int tx,
                      int ty, int ps, int gx, int gy, int gz, int vec,
                      const void* x, int x_align, const void* y,
                      int y_align) {
  const bool block_ok = tx >= 1 && tx <= 32 && (tx & (tx - 1)) == 0 &&
                        ty >= 1 && ty <= THREADS && ps >= 1 && ps <= THREADS;
  const int threads = block_ok ? tx * ty * ps : 0;
  const bool ok =
      threads >= 32 && threads <= THREADS && threads % 32 == 0 &&
      4LL * h * w <= INT_MAX && gx >= 1 && gy >= 1 &&
      gy <= GRID_YZ_MAX && gz >= 1 && gz <= GRID_YZ_MAX &&
      2LL * tx * gx >= w && 1LL * rows * ty * gy >= h &&
      1LL * ps * gz >= planes &&
      (!vec || (w % 2 == 0 &&
                reinterpret_cast<unsigned long long>(x) % x_align == 0 &&
                reinterpret_cast<unsigned long long>(y) % y_align == 0));
  return ok ? 0 : PLAN_REFUSED;
}

}  // namespace resample2x
