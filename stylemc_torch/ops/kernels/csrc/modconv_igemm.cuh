// The implicit GEMM on the tensor cores that the fused synthesis layer's
// forward (B3, modconv_fwd.cu) and its data gradient (B4,
// modconv_bwd_data.cu) share: one 3x3 convolution (pad 1, stride 1),
//
//   acc[n,m,p] = sum_k sum_t wt[m,k,t] * scale[n,k] * in[n,k,p + off_t]
//
// with tap t = 3*di + dj at offset (di - 1, dj - 1), M rows, K input
// channels, float32 in and out. B3 runs it with M = CO, K = CI, in = x,
// scale = s and wt = w; B4 (the transposed convolution) with M = CI,
// K = CO, in = dz, scale = d and wt the flipped, transposed w
// (split_w_kernel<true>). Each instantiates igemm_kernel with its own
// epilogue, which receives the block's fp32 accumulators.
//
// Design: mma.sync.m16n8k8 TF32 in 3xTF32 (three TF32 products per fp32
// product, which keeps fp32's accuracy where one TF32 pass misses the
// layer's gates).
// - The weight is the same for every sample and pixel, so a first launch
//   splits it once per call into (big, small) TF32 pairs, laid out for
//   each 64-row M tile as [K_pad][9][68]: a chunk's rows are the
//   shared-memory image of its weight slice (4 pairs of padding a row keep
//   the fragment reads free of bank conflicts) and arrive by one bulk copy
//   (cp.async.bulk, the copy engine's 1-D form) that completes on an
//   mbarrier, so the threads spend no instructions on the weight.
// - A block owns 64 rows x a pixel chunk of one sample, 16 rows x 16
//   columns (16 x 8 for planes at most 8 wide), and walks its K range 8
//   channels (a chunk) at a time, each chunk covering all nine taps. 8
//   warps of 32 rows x 8 pixel rows x 8 columns (4 rows for the narrow
//   chunk): 64 fp32 accumulators a thread for the block's whole K range
//   and 64 for the chunk at hand (B3: 224-226 registers, no spills).
// - A 3-stage ring stages, per chunk, the weight slice, the raw haloed
//   input chunk [8 k][18][PW+8] (columns j0-4 .. j0+PW+3, so every row
//   starts 16-byte aligned; 16-byte cp.async, 4-byte where W % 4 != 0 or
//   the input is not 16-byte aligned; zero-filled outside the plane and
//   past K) and the chunk's 8 values of scale[n,:]. The next chunks' copies
//   fly while the tensor cores work on this one; a chunk costs one barrier.
// - in*scale is split into (big, small) in registers as each warp reads its
//   b fragments. A pass that split the chunk into pairs in shared memory
//   before the barrier, with the weight staged by every thread's cp.async,
//   left the tensor cores idle meanwhile and measured slower on the H100 at
//   every conv1 shape (PERF.md).
// - The same input chunk serves all nine taps: tap (di, dj) of output row
//   q reads staged row q + di shifted by dj, which mma.sync's fragments
//   allow at any offset. A warp reads and splits each of its NT+2 staged
//   rows once per dj and uses it for up to three di. Channel strides of 8
//   or 24 mod 32 floats keep the shifted b reads free of bank conflicts.
// - Each fragment pair issues small*big, big*small, big*big (CUTLASS's
//   3xTF32 order) into fp32 fragments that start from zero at each chunk
//   and are added to the accumulators in fp32 when it ends: the tensor
//   cores' own sums truncate, and whole-K sums measured past B3's gate on
//   the H100 (at 32x32, batch 4) and no faster.
// - Warps whose pixels lie wholly outside the plane skip their MMAs.
// - Small planes leave too few (M tile, chunk) blocks for 132 SMs, so the
//   wrappers' plan (modconv.py, fwd_plan) splits the K range over blocks
//   (blockIdx.z): each then writes fp32 partials [splits,N,M,H,W] and a
//   later launch sums them in a fixed order (deterministic, no atomics).

#pragma once

#include <cstdint>

#include "modconv_tc.cuh"

namespace modconv_igemm {

using namespace modconv_tc;

constexpr int THREADS = 256;
constexpr int BM = 64;              // rows (m) of a block tile
constexpr int WM = 32;              // rows of a warp tile
constexpr int MT = WM / 16;         // its m16 fragments
constexpr int PX_GROUPS = THREADS / 32 / (BM / WM);   // warps along pixels
constexpr int PR = 16;              // rows of a pixel chunk
constexpr int KC = 8;               // input channels of a chunk: one k step
constexpr int STAGES = 3;
constexpr int LDW = BM + 4;         // pairs between two (k, tap) rows
constexpr int W_CH = 9 * LDW;       // pairs between two channels' rows
constexpr unsigned W_BYTES = KC * 9 * LDW * 8;   // a chunk's weight slice

static_assert(W_CH % 16 == 4, "conflict-free a fragments");
static_assert(W_BYTES % 16 == 0, "bulk copies move 16-byte units");

// the least stride >= v (a multiple of 4) that is 8 or 24 mod 32 floats:
// channels t = 0..3 of a b fragment then fall in distinct 8-bank groups
__host__ __device__ constexpr int conflict_free_stride(int v) {
  return (v % 32 == 8 || v % 32 == 24) ? v : conflict_free_stride(v + 4);
}

// A chunk of PR x PW pixels: each warp's tile is NT rows x 8 columns of
// it (NT = 8 for 16 columns, 4 for 8). A stage of shared memory, in
// floats: the weight slice (pairs [KC][9][LDW]), the raw input chunk
// [KC][LDX] (rows of XW) and the chunk's KC scale values.
template <int PW>
struct Geometry {
  static constexpr int NT = PR * PW / 8 / PX_GROUPS;   // n8 fragments
  static constexpr int XW = PW + 8;            // staged row: j0-4 .. j0+PW+3
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

// Calls f(channel, staged row, staged column) for each input copy of a
// chunk that this thread makes (V floats each).
template <int PW, bool VEC, class F>
__device__ __forceinline__ void in_copies(F&& f) {
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

// Where a block and its warp sit: the pixel chunk (blockIdx.x, n-major),
// the M tile (blockIdx.y); the K split is blockIdx.z.
struct Block {
  Tile tl;
  int rc;          // the chunk's index within its plane
  int m0;          // first row of the M tile
  int wm;          // the warp's 32-row half of the tile
  int pg;          // the warp's pixel group
  int rq, cq;      // the pixel group's first row and column in the chunk
  bool active;     // some of the warp's pixels lie in the plane
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

// Stage the raw input and the scale values of one chunk (channels k0 ..
// k0+KC-1) into `st` with cp.async (not waited for here).
template <int PW, bool VEC>
__device__ __forceinline__ void load_in(float* st, const float* __restrict__ in,
                                        const float* __restrict__ scale,
                                        Tile tl, int k0, int K, int H, int W) {
  using G = Geometry<PW>;
  if (threadIdx.x < KC) {
    const bool ok = k0 + static_cast<int>(threadIdx.x) < K;
    cp_async4(st + G::S_OFF + threadIdx.x,
              scale + (ok ? static_cast<long long>(tl.n) * K + k0 + threadIdx.x
                          : 0),
              ok);
  }
  const long long plane = static_cast<long long>(H) * W;
  float* raw = st + G::X_OFF;
  in_copies<PW, VEC>([&](int cl, int r, int c) {
    const int gi = tl.i0 + r - 1;
    const int gj = tl.j0 - 4 + c;
    // W % 4 == 0 on the 16-byte path: 4 pixels wholly inside or outside
    const bool ok = gi >= 0 && gi < H && gj >= 0 && gj < W && k0 + cl < K;
    const long long off =
        ok ? (static_cast<long long>(tl.n) * K + k0 + cl) * plane +
                 static_cast<long long>(gi) * W + gj
           : 0;
    if (VEC)
      cp_async16(raw + cl * G::LDX + r * G::XW + c, in + off, ok);
    else
      cp_async4(raw + cl * G::LDX + r * G::XW + c, in + off, ok);
  });
}

// The warp's 32 rows x NT pixel rows x 8 pixels over one staged chunk (8 k
// x 9 taps), summed in fragments that start from zero and then added to
// acc.
template <int PW, int NT = Geometry<PW>::NT>
__device__ __forceinline__ void mma_chunk(const float* st,
                                          float (&acc)[MT][NT][4], int wm,
                                          int rq, int cq) {
  using G = Geometry<PW>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in the group
  // a (16 m x 8 k, row-major): m g and g+8, k t and t+4
  const uint2* wa = reinterpret_cast<const uint2*>(st) + t * W_CH + wm * WM +
                    g;
  // b (8 k x 8 px, column-major): px g, k t and t+4, scaled by their
  // scale values; staged column 3 is the halo column j0-1
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

// One block: BM rows x one pixel chunk x the K range of split blockIdx.z
// (blockIdx.x the chunk, n-major; blockIdx.y the M tile), then
// epi(acc, block, M, H, W, chunks of a plane), called by every thread.
// Accumulator c of fragment (mt, q) is row wm*WM + mt*16 + g + 8*(c/2) of
// the tile at pixel row rq + q, column cq + 2t + c%2 of the chunk
// (g = lane/4, t = lane%4).
template <int PW, bool VEC, class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
igemm_kernel(const float* __restrict__ in, const float* __restrict__ wsplit,
             const float* __restrict__ scale, int K, int M, int H, int W,
             Epilogue epi) {
  using G = Geometry<PW>;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t wbar[STAGES];   // a stage's weights
  const int cols = (W + PW - 1) / PW;
  const int chunks_per_plane = ((H + PR - 1) / PR) * cols;
  Block b;
  b.rc = static_cast<int>(blockIdx.x % chunks_per_plane);
  b.tl = Tile{static_cast<int>(blockIdx.x / chunks_per_plane),
              (b.rc / cols) * PR, (b.rc % cols) * PW};
  b.m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  // this split's K chunks [c_begin, c_begin + count): fwd_plan's ranges
  const int chunks = (K + KC - 1) / KC;
  const int c_begin = chunks * split / gridDim.z;
  const int count = chunks * (split + 1) / gridDim.z - c_begin;
  // this M tile's split weight, from the split's first chunk
  const float* wtile = wsplit + (static_cast<long long>(blockIdx.y) * chunks +
                                 c_begin) * (W_BYTES / 4);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&wbar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  b.wm = warp % (BM / WM);
  b.pg = warp / (BM / WM);                    // pixel group of the chunk
  b.rq = (b.pg / (PW / 8)) * G::NT;           // its first row
  b.cq = (b.pg % (PW / 8)) * 8;               // its first column
  b.active = b.tl.i0 + b.rq < H && b.tl.j0 + b.cq < W;

  float acc[MT][G::NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int q = 0; q < G::NT; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][q][c] = 0.0f;

  // chunk j into its stage: the weights by thread 0's bulk copy, the
  // input and scale by every thread's cp.async
  const auto load = [&](int j) {
    float* st = smem + (j % STAGES) * G::STAGE;
    if (threadIdx.x == 0) {
      // the stage was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(st, wtile + static_cast<long long>(j) * (W_BYTES / 4),
                W_BYTES, &wbar[j % STAGES]);
    }
    load_in<PW, VEC>(st, in, scale, b.tl, (c_begin + j) * KC, K, H, W);
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
    if (b.active) mma_chunk<PW>(st, acc, b.wm, b.rq, b.cq);
  }
  cp_async_wait<0>();
  epi(acc, b, M, H, W, chunks_per_plane);
}

// w [CO,CI,3,3] -> (big, small) pairs [M_pad / BM][K_pad][9][LDW]: for
// each M tile, rows of its BM channels (the last LDW - BM pairs of a row
// are padding, never read), zeros past K and M. B3 (FLIP false): m = co,
// k = ci, tap t of w[co][ci]. B4 (FLIP true): m = ci, k = co, tap 8 - t of
// w[co][ci] (the transposed convolution's flipped taps). One thread per
// (k, m), m fastest, so each tap's stores are contiguous.
template <bool FLIP>
__global__ void split_w_kernel(const float* __restrict__ w,
                               float* __restrict__ wsplit, int K, int M,
                               int K_pad, int M_pad) {
  const long long total = static_cast<long long>(K_pad) * M_pad;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(idx % M_pad);
    const int k = static_cast<int>(idx / M_pad);
    const bool ok = k < K && m < M;
    const float* src =
        w + (FLIP ? static_cast<long long>(k) * M + m
                  : static_cast<long long>(m) * K + k) * 9;
    uint2* dst = reinterpret_cast<uint2*>(wsplit) +
                 (static_cast<long long>(m / BM) * K_pad + k) * 9 * LDW +
                 m % BM;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t big, small;
      split_tf32(ok ? __ldg(src + (FLIP ? 8 - tap : tap)) : 0.0f, big, small);
      dst[tap * LDW] = make_uint2(big, small);
    }
  }
}

// Blocks of a grid-stride loop over `total` (> 0) elements.
inline int grid_for(long long total) {
  const long long blocks = (total + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

// The weight split for an M x K layer on `stream`; returns its CUDA error.
template <bool FLIP>
int split_w(const float* w, float* wsplit, int K, int M, cudaStream_t stream) {
  const int K_pad = (K + KC - 1) / KC * KC;
  const int M_pad = (M + BM - 1) / BM * BM;
  if (K_pad == 0) return 0;
  split_w_kernel<FLIP><<<grid_for(static_cast<long long>(K_pad) * M_pad),
                         THREADS, 0, stream>>>(w, wsplit, K, M, K_pad, M_pad);
  return static_cast<int>(cudaGetLastError());
}

template <int PW, bool VEC, class Epilogue>
int launch_tiles(const float* in, const float* wsplit, const float* scale,
                 int N, int K, int M, int H, int W, int splits,
                 const Epilogue& epi, cudaStream_t stream) {
  using G = Geometry<PW>;
  auto kernel = igemm_kernel<PW, VEC, Epilogue>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>(N) *
                          ((H + PR - 1) / PR) * ((W + PW - 1) / PW);
  const dim3 grid(static_cast<unsigned>(units), (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(in, wsplit, scale, K, M, H, W,
                                             epi);
  return static_cast<int>(cudaGetLastError());
}

// igemm_kernel over the plan's grid: chunk_cols (8 or 16) columns a pixel
// chunk, `splits` K splits; vec != 0 promises W % 4 == 0 and a 16-byte
// aligned `in`. Returns the CUDA error code (0 on success).
template <class Epilogue>
int launch_igemm(const float* in, const float* wsplit, const float* scale,
                 int N, int K, int M, int H, int W, int splits, int chunk_cols,
                 int vec, const Epilogue& epi, cudaStream_t stream) {
  if (chunk_cols != 8 && chunk_cols != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto launch) {
    return launch(in, wsplit, scale, N, K, M, H, W, splits, epi, stream);
  };
  return chunk_cols == 16
             ? (vec ? go(launch_tiles<16, true, Epilogue>)
                    : go(launch_tiles<16, false, Epilogue>))
             : (vec ? go(launch_tiles<8, true, Epilogue>)
                    : go(launch_tiles<8, false, Epilogue>));
}

}  // namespace modconv_igemm
