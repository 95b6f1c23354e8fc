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
// Design: an implicit GEMM on mma.sync.m16n8k8 TF32.
// - The weight is the same for every sample and pixel, so a first launch
//   splits it once per call into (big, small) TF32 pairs, laid out for
//   each 64-channel CO tile as [CI_pad][9][68]: a chunk's rows are the
//   shared-memory image of its weight slice (4 pairs of padding a row keep
//   the fragment reads free of bank conflicts) and arrive by one bulk copy
//   (cp.async.bulk, the copy engine's 1-D form) that completes on an
//   mbarrier, so the threads spend no instructions on the weight.
// - A block owns 64 CO x a pixel chunk of one sample, 16 rows x 16 columns
//   (16 x 8 for planes at most 8 wide), and walks its CI range 8 channels
//   (a chunk) at a time, each chunk covering all nine taps. 8 warps of 32
//   CO x 8 rows x 8 columns (4 rows for the narrow chunk): 64 fp32
//   accumulators a thread for the block's whole K range and 64 for the
//   chunk at hand (224-226 registers, no spills).
// - A 3-stage ring stages, per chunk, the weight slice, the raw haloed x
//   chunk [8 ci][18][PW+8] (columns j0-4 .. j0+PW+3, so every row starts
//   16-byte aligned; 16-byte cp.async, 4-byte where W % 4 != 0 or x is not
//   16-byte aligned; zero-filled outside the plane and past CI) and the
//   chunk's 8 values of s[n,:]. The next chunks' copies fly while the
//   tensor cores work on this one; a chunk costs one barrier.
// - x*s is split into (big, small) in registers as each warp reads its b
//   fragments, as B5 splits x. A pass that split the chunk into pairs in
//   shared memory before the barrier, with the weight staged by every
//   thread's cp.async, left the tensor cores idle meanwhile and measured
//   slower on the H100 at every conv1 shape (PERF.md).
// - The same x chunk serves all nine taps: tap (di, dj) of output row q
//   reads staged row q + di shifted by dj, which mma.sync's fragments allow
//   at any offset. A warp reads and splits each of its NT+2 staged rows
//   once per dj and uses it for up to three di. Channel strides of 8 or 24
//   mod 32 floats keep the shifted b reads free of bank conflicts.
// - Each fragment pair issues small*big, big*small, big*big (CUTLASS's
//   3xTF32 order) into fp32 fragments that start from zero at each chunk
//   and are added to the accumulators in fp32 when it ends: the tensor
//   cores' own sums truncate, and whole-K sums measured past B3's gate on
//   the H100 (at 32x32, batch 4) and no faster.
// - Warps whose pixels lie wholly outside the plane skip their MMAs.
// - Small planes (4x4 to 16x16) leave too few (CO tile, chunk) blocks for
//   132 SMs, so the wrapper's plan (modconv.py, fwd_plan) splits the CI
//   range over blocks: each writes fp32 partials [splits,N,CO,H,W] and a
//   third launch sums them in a fixed order (deterministic, no atomics)
//   and applies the epilogue. Unsplit, the epilogue runs in registers:
//   d[n,co], noise, bias, lrelu(0.2) * gain and the clamp, y written once.

#include <cstdint>

#include "modconv_tc.cuh"

namespace {

using namespace modconv_tc;

constexpr int THREADS = 256;
constexpr int BM = 64;              // output channels (co) of a block tile
constexpr int WM = 32;              // co of a warp tile
constexpr int MT = WM / 16;         // its m16 fragments
constexpr int PX_GROUPS = THREADS / 32 / (BM / WM);   // warps along pixels
constexpr int PR = 16;              // rows of a pixel chunk
constexpr int KC = 8;               // input channels of a chunk: one k step
constexpr int STAGES = 3;
constexpr int LDW = BM + 4;         // pairs between two (ci, tap) rows
constexpr int W_CH = 9 * LDW;       // pairs between two channels' rows
constexpr unsigned W_BYTES = KC * 9 * LDW * 8;   // a chunk's weight slice
constexpr float LRELU_SLOPE = 0.2f;

static_assert(W_CH % 16 == 4, "conflict-free a fragments");
static_assert(W_BYTES % 16 == 0, "bulk copies move 16-byte units");

// the least stride >= v (a multiple of 4) that is 8 or 24 mod 32 floats:
// channels t = 0..3 of a b fragment then fall in distinct 8-bank groups
__host__ __device__ constexpr int conflict_free_stride(int v) {
  return (v % 32 == 8 || v % 32 == 24) ? v : conflict_free_stride(v + 4);
}

// A chunk of PR x PW pixels: each warp's tile is NT rows x 8 columns of
// it (NT = 8 for 16 columns, 4 for 8). A stage of shared memory, in
// floats: the weight slice (pairs [KC][9][LDW]), the raw x chunk
// [KC][LDX] (rows of XW) and the chunk's KC values of s.
template <int PW>
struct Geometry {
  static constexpr int NT = PR * PW / 8 / PX_GROUPS;   // n8 fragments
  static constexpr int XW = PW + 8;            // staged x row: j0-4 .. j0+PW+3
  static constexpr int XROWS = PR + 2;
  static constexpr int LDX = conflict_free_stride(XROWS * XW);
  static constexpr int X_OFF = W_BYTES / 4;
  static constexpr int S_OFF = X_OFF + KC * LDX;
  static constexpr int STAGE = S_OFF + KC;
  static constexpr int SMEM = STAGES * STAGE * 4;   // bytes
  static_assert(PW % 8 == 0 && PR % NT == 0 && NT * 8 * PX_GROUPS ==
                PR * PW, "tiling");
  static_assert(XW % 4 == 0 && LDX % 4 == 0 && STAGE % 4 == 0,
                "16-byte aligned copies");
  static_assert(SMEM <= 232448 - 64, "fits shared memory beside the barriers");
};

// Calls f(channel, staged row, staged column) for each x copy of a chunk
// that this thread makes (V floats each).
template <int PW, bool VEC, class F>
__device__ __forceinline__ void x_copies(F&& f) {
  using G = Geometry<PW>;
  constexpr int V = VEC ? 4 : 1;
  constexpr int XQ = G::XW / V;
  constexpr int RQ = G::XROWS * XQ;   // copies of a channel
  constexpr int TPG = RQ >= THREADS ? THREADS : pow2_at_least(RQ);
  for (int rq = threadIdx.x % TPG; rq < RQ; rq += TPG)
    for (int cl = threadIdx.x / TPG; cl < KC; cl += THREADS / TPG)
      f(cl, rq / XQ, V * (rq % XQ));
}

struct Tile {
  int n, i0, j0;   // sample, top-left pixel of the chunk
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1u)
               : "memory");
}

// `bytes` from global `src` to shared `dst` by one bulk copy whose
// completion the next phase of `bar` waits for.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the completion of phase `parity` of `bar`; a copy that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 22)) __trap();
  }
}

// Stage the raw x and the s values of one chunk (input channels ci0 ..
// ci0+KC-1) into `st` with cp.async (not waited for here).
template <int PW, bool VEC>
__device__ __forceinline__ void load_x(float* st, const float* __restrict__ x,
                                       const float* __restrict__ s, Tile tl,
                                       int ci0, int CI, int H, int W) {
  using G = Geometry<PW>;
  if (threadIdx.x < KC) {
    const bool ok = ci0 + static_cast<int>(threadIdx.x) < CI;
    cp_async4(st + G::S_OFF + threadIdx.x,
              s + (ok ? static_cast<long long>(tl.n) * CI + ci0 + threadIdx.x
                      : 0),
              ok);
  }
  const long long plane = static_cast<long long>(H) * W;
  float* raw = st + G::X_OFF;
  x_copies<PW, VEC>([&](int cl, int r, int c) {
    const int gi = tl.i0 + r - 1;
    const int gj = tl.j0 - 4 + c;
    // W % 4 == 0 on the 16-byte path: 4 pixels wholly inside or outside
    const bool ok = gi >= 0 && gi < H && gj >= 0 && gj < W && ci0 + cl < CI;
    const long long off =
        ok ? (static_cast<long long>(tl.n) * CI + ci0 + cl) * plane +
                 static_cast<long long>(gi) * W + gj
           : 0;
    if (VEC)
      cp_async16(raw + cl * G::LDX + r * G::XW + c, x + off, ok);
    else
      cp_async4(raw + cl * G::LDX + r * G::XW + c, x + off, ok);
  });
}

// The warp's 32 co x NT rows x 8 pixels over one staged chunk (8 ci x 9
// taps), summed in fragments that start from zero and then added to acc.
template <int PW, int NT = Geometry<PW>::NT>
__device__ __forceinline__ void mma_chunk(const float* st,
                                          float (&acc)[MT][NT][4], int wm,
                                          int rq, int cq) {
  using G = Geometry<PW>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in the group
  // a (16 co x 8 ci, row-major): co g and g+8, ci t and t+4
  const uint2* wa = reinterpret_cast<const uint2*>(st) + t * W_CH + wm * WM +
                    g;
  // b (8 ci x 8 px, column-major): px g, ci t and t+4, scaled by their s;
  // staged column 3 is the halo column j0-1
  const float* xb = st + G::X_OFF + t * G::LDX + rq * G::XW + 3 + cq + g;
  const float s0 = st[G::S_OFF + t];
  const float s1 = st[G::S_OFF + t + 4];
  float part[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[a][b][c] = 0.0f;
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    // staged rows rq .. rq+NT+1 at shift dj: row q + di serves output row
    // q under tap (di, dj)
    uint32_t bb[NT + 2][2], bs[NT + 2][2];
#pragma unroll
    for (int r = 0; r < NT + 2; ++r) {
      split_tf32(xb[r * G::XW + dj] * s0, bb[r][0], bs[r][0]);
      split_tf32(xb[r * G::XW + dj + 4 * G::LDX] * s1, bb[r][1], bs[r][1]);
    }
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const uint2* wt = wa + (di * 3 + dj) * LDW;
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int off[4] = {0, 8, 4 * W_CH, 4 * W_CH + 8};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 v = wt[mt * 16 + off[i]];
          ab[mt][i] = v.x;
          as[mt][i] = v.y;
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NT; ++q) mma_tf32(part[mt][q], as[mt], bb[q + di]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NT; ++q) mma_tf32(part[mt][q], ab[mt], bs[q + di]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NT; ++q) mma_tf32(part[mt][q], ab[mt], bb[q + di]);
    }
  }
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] += part[a][b][c];
}

__device__ __forceinline__ float epilogue(float acc, float dm, float nz,
                                          float bm, float gain, float clamp,
                                          int has_clamp) {
  const float z = acc * dm + nz + bm;
  float v = (z >= 0.0f ? z : z * LRELU_SLOPE) * gain;
  if (has_clamp) v = fminf(fmaxf(v, -clamp), clamp);
  return v;
}

// One block: BM co x one pixel chunk x the CI range of split blockIdx.z
// (blockIdx.x the chunk, n-major; blockIdx.y the CO tile). With
// gridDim.z == 1 it writes y; else out is partial [splits,N,CO,H,W].
template <int PW, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
modconv_fwd_tc_kernel(const float* __restrict__ x,
                      const float* __restrict__ wsplit,
                      const float* __restrict__ s, const float* __restrict__ d,
                      const float* __restrict__ noise,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int N, int CI, int CO, int H, int W, float gain,
                      float clamp, int has_clamp) {
  using G = Geometry<PW>;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t wbar[STAGES];   // a stage's weights
  const int cols = (W + PW - 1) / PW;
  const int chunks_per_plane = ((H + PR - 1) / PR) * cols;
  const int rc = static_cast<int>(blockIdx.x % chunks_per_plane);
  const Tile tl{static_cast<int>(blockIdx.x / chunks_per_plane),
                (rc / cols) * PR, (rc % cols) * PW};
  const int co0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  // this split's CI chunks [c_begin, c_begin + count): fwd_plan's ranges
  const int chunks = (CI + KC - 1) / KC;
  const int c_begin = chunks * split / gridDim.z;
  const int count = chunks * (split + 1) / gridDim.z - c_begin;
  // this CO tile's split weight, from the split's first chunk
  const float* wtile = wsplit + (static_cast<long long>(blockIdx.y) * chunks +
                                 c_begin) * (W_BYTES / 4);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&wbar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int wm = warp % (BM / WM);
  const int pg = warp / (BM / WM);            // pixel group of the chunk
  const int rq = (pg / (PW / 8)) * G::NT;     // its first row
  const int cq = (pg % (PW / 8)) * 8;         // its first column
  const bool active = tl.i0 + rq < H && tl.j0 + cq < W;

  float acc[MT][G::NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < G::NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  // chunk j into its stage: the weights by thread 0's bulk copy, x and s
  // by every thread's cp.async
  const auto load = [&](int j) {
    float* st = smem + (j % STAGES) * G::STAGE;
    if (threadIdx.x == 0) {
      // the stage was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(st, wtile + static_cast<long long>(j) * (W_BYTES / 4),
                W_BYTES, &wbar[j % STAGES]);
    }
    load_x<PW, VEC>(st, x, s, tl, (c_begin + j) * KC, CI, H, W);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const float* st = smem + (i % STAGES) * G::STAGE;
    cp_async_wait<STAGES - 2>();
    mbar_wait(&wbar[i % STAGES], (i / STAGES) & 1);
    // chunk i has landed for every thread, and every warp is done with
    // chunk i-1, whose stage the next copy fills
    __syncthreads();
    if (i + STAGES - 1 < count) load(i + STAGES - 1);
    cp_async_commit();
    if (active) mma_chunk<PW>(st, acc, wm, rq, cq);
  }
  cp_async_wait<0>();
  if (!active) return;

  // accumulator c of fragment (mt, q): co row g + 8 * (c / 2), pixel row
  // q, column 2t + c % 2
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long plane = static_cast<long long>(H) * W;
  const bool unsplit = gridDim.z == 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int co = co0 + wm * WM + mt * 16 + g + 8 * hf;
      if (co >= CO) continue;
      const long long nco = static_cast<long long>(tl.n) * CO + co;
      const float dm = unsplit ? __ldg(d + nco) : 1.0f;
      const float bm = unsplit ? __ldg(bias + co) : 0.0f;
      float* orow = out + (static_cast<long long>(split) * N * CO + nco) * plane;
#pragma unroll
      for (int q = 0; q < G::NT; ++q) {
        const int i = tl.i0 + rq + q;
        if (i >= H) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = tl.j0 + cq + 2 * t + e;
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

// w [CO,CI,3,3] -> (big, small) pairs [CO_pad / BM][CI_pad][9][LDW]: for
// each CO tile, rows of its BM output channels (the last LDW - BM pairs of
// a row are padding, never read), zeros past CI and CO. One thread per
// (ci, co), co fastest, so each tap's stores are contiguous.
__global__ void modconv_fwd_split_w_kernel(const float* __restrict__ w,
                                           float* __restrict__ wsplit, int CI,
                                           int CO, int CI_pad, int CO_pad) {
  const long long total = static_cast<long long>(CI_pad) * CO_pad;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int co = static_cast<int>(idx % CO_pad);
    const int ci = static_cast<int>(idx / CO_pad);
    const bool ok = ci < CI && co < CO;
    const float* src = w + (static_cast<long long>(co) * CI + ci) * 9;
    uint2* dst = reinterpret_cast<uint2*>(wsplit) +
                 (static_cast<long long>(co / BM) * CI_pad + ci) * 9 * LDW +
                 co % BM;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t b, sm;
      split_tf32(ok ? __ldg(src + tap) : 0.0f, b, sm);
      dst[tap * LDW] = make_uint2(b, sm);
    }
  }
}

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

// Blocks of a grid-stride loop over `total` (> 0) elements.
int grid_for(long long total) {
  const long long blocks = (total + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <int PW, bool VEC>
int launch(const float* x, const float* wsplit, const float* s,
           const float* d, const float* noise, const float* bias, float* out,
           int N, int CI, int CO, int H, int W, int CO_pad, float gain,
           float clamp, int has_clamp, int splits, cudaStream_t stream) {
  using G = Geometry<PW>;
  auto kernel = modconv_fwd_tc_kernel<PW, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>(N) *
                          ((H + PR - 1) / PR) * ((W + PW - 1) / PW);
  const dim3 grid(static_cast<unsigned>(units), CO_pad / BM, splits);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(x, wsplit, s, d, noise, bias,
                                             out, N, CI, CO, H, W, gain,
                                             clamp, has_clamp);
  return static_cast<int>(cudaGetLastError());
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
  if (chunk_cols != 8 && chunk_cols != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int CI_pad = (CI + KC - 1) / KC * KC;
  const int CO_pad = (CO + BM - 1) / BM * BM;
  float* ws = static_cast<float*>(wsplit);
  if (CI_pad > 0) {
    modconv_fwd_split_w_kernel<<<grid_for(static_cast<long long>(CI_pad) *
                                          CO_pad),
                                 THREADS, 0, st>>>(
        static_cast<const float*>(w), ws, CI, CO, CI_pad, CO_pad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* out = static_cast<float*>(splits > 1 ? partial : y);
  const auto args = [&](auto fn) {
    return fn(static_cast<const float*>(x), ws, static_cast<const float*>(s),
              static_cast<const float*>(d), static_cast<const float*>(noise),
              static_cast<const float*>(bias), out, N, CI, CO, H, W, CO_pad,
              gain, clamp, has_clamp, splits, st);
  };
  int err = chunk_cols == 16
                ? (vec ? args(launch<16, true>) : args(launch<16, false>))
                : (vec ? args(launch<8, true>) : args(launch<8, false>));
  if (err != 0 || splits == 1) return err;
  modconv_fwd_reduce_kernel<<<grid_for(static_cast<long long>(N) * CO * H *
                                       W),
                              THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(d),
      static_cast<const float*>(noise), static_cast<const float*>(bias),
      static_cast<float*>(y), N, CO, H, W, splits, gain, clamp, has_clamp);
  return static_cast<int>(cudaGetLastError());
}
