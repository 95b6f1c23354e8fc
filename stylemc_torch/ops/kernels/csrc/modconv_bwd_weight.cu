// The fused modulated synthesis layer, backward to the weight (the direct
// term), float32 in and out:
//
//   dW[co,ci,t] = sum_n d[n,co] s[n,ci] sum_px dz[n,co,px] x[n,ci,px+off_t]
//
// with dz = dy * g(y), the lrelu/clamp gradient rebuilt from the output y;
// the wrapper adds the demodulation's term 2 w (s^2)^T dsig.
//
// Replaces the TPU kernel stylemc_tpu/ops/pallas/modconv_pallas.py,
// functions _bwd_weight_kernel / _bwd_weight_call. Same function, and like
// the TPU kernel it scales each sample's [CO,CI] contribution by
// d[n,co] * s[n,ci]. The TPU kernel accumulates dW across its sequential
// (n, row tile) grid; blocks here run in no order, so the (n, pixel)
// reduction is split across blocks into partials [splits][CO][CI][9] that
// the wrapper sums in a fixed order: deterministic, no atomics. The
// wrapper plans the split (modconv.py, bwd_weight_plan) and calls the
// kernel only when the weight needs a gradient.
//
// What bounds it on an H100: operations. An implicit GEMM with M = CO,
// N = CI x 9 taps and K = (n, pixel), 2*N*CO*CI*9*H*W flops, done on the
// tensor cores in 3xTF32 (three TF32 products per fp32 product, which keeps
// fp32's accuracy where one TF32 pass misses the 1e-5 gate;
// tests/test_torch_modconv_tc.py emulates both): 3x the contraction's
// flops at 495 TFLOP/s, 1.5612 ms summed over FFHQ-256's seven conv1
// layers at batch 4. The bytes (dy, y, x read once, dW written once) take
// a quarter of that at 256x256, less elsewhere but at 4x4. mma.sync, the
// route taken here, runs near 300 TFLOP/s of TF32 on the card
// (stylemc_torch/bench/mma_rate.py), so 3xTF32 through it tops out near
// 100; wgmma, not taken, reaches 495.
//
// Design: an implicit GEMM on mma.sync.m16n8k8 TF32, fed by cp.async.
// - A block owns 64 CO x 32 CI x 9 taps (8 warps of 32 CO x 8 CI x 9 taps:
//   72 fp32 accumulators a thread for the block's whole K range, and 72
//   for the chunk at hand) and walks its split's (n, pixel chunk) units; a
//   chunk is 128 pixels, PR rows x PW columns (8 x 16, or 16 x 8 for
//   planes at most 8 wide).
// - A 2-stage ring of cp.async copies (16 B, zero-filled outside the plane,
//   past CO/CI and in the halo; 4 B copies where W % 4 != 0 or a pointer is
//   not 16-byte aligned) stages the dy and y chunk [64 co][128 px], the
//   haloed x chunk [32 ci][PR+2][PW+8] (columns j0-4 .. j0+PW+3, so every
//   row starts 16-byte aligned) and the sample's d and s slices; the next
//   chunk's copies fly while the tensor cores work on this one.
// - Each operand is split into big = rna_tf32(v) and small =
//   rna_tf32(v - big) once: before the chunk's one barrier, each thread
//   computes dz = dy * g(y) over the dy and y float4s that it copied itself
//   and writes big over dy and small over y; x is split in registers as
//   each warp walks a column group down the chunk's rows. The same x chunk
//   serves all nine taps: tap (di, dj) of k row kr reads x row kr + di,
//   shifted by dj, which mma.sync's fragments allow at any offset (channel
//   strides of 4 mod 8 floats keep the shifted reads free of bank
//   conflicts), so consecutive k rows share two of their three x rows and
//   a 3-row window of split fragments is carried in registers.
// - Each fragment pair issues small*big, big*small, big*big (CUTLASS's
//   3xTF32 order) into fp32 fragments that start from zero at each chunk.
//   The chunk's fragments are then scaled by the sample's d[co] * s[ci]
//   and added to the block's accumulators in fp32 FMAs on the CUDA cores:
//   the tensor cores' own sums truncate (below).
// - Measured on the H100 and kept out: x split once per chunk into (big,
//   small) pairs in shared memory (twice its room and its shared loads,
//   more registers: slower), 16 warps of 16 CO (more split work per
//   MMA: slower), the accumulators in shared memory (no faster), the next
//   chunk's copies spread over this chunk's k steps (no faster, even with
//   their addresses worked out once a chunk), cvt.rna.tf32.f32 for the
//   rounding (a test for inf and NaN around the same two integer
//   operations: slower).
// - k steps (8 pixels of one row) that lie wholly outside the plane are
//   skipped, so 4x4 and 20-wide planes do not pay for a whole chunk.
// - The epilogue stages the tile through shared memory so that each block
//   writes its [64 co][32 ci x 9] partial with coalesced stores.

#include <cstdint>

#include "modconv_common.cuh"
#include "modconv_tc.cuh"

namespace {

using modconv::act_grad;
using namespace modconv_tc;

constexpr int DW_THREADS = 256;
constexpr int BM = 64;              // output channels (co) of a block tile
constexpr int BN = 32;              // input channels (ci) of a block tile
constexpr int WM = 32;              // co of a warp tile
constexpr int MT = WM / 16;         // its m16 fragments
constexpr int WN = 8;               // ci of a warp tile: one n8 fragment
constexpr int WARPS_N = BN / WN;
constexpr int PIX = 128;            // pixels of a chunk
constexpr int LDA = PIX + 4;        // row stride of the dy and y tiles
constexpr int STAGES = 2;
constexpr int OUT_LD = BN * 9 + 4;  // row stride of the epilogue's tile

static_assert((BM / WM) * WARPS_N * 32 == DW_THREADS, "a warp per tile");
static_assert(LDA % 8 == 4, "conflict-free a fragments");

// A stage of shared memory, in floats: dy (then dz's big half) [BM][LDA],
// y (then dz's small half) [BM][LDA], x [BN][LDX] (rows of XW), d [BM]
// and s [BN] of the sample.
template <int PW>
struct Geometry {
  static constexpr int PR = PIX / PW;        // chunk rows
  static constexpr int XW = PW + 8;          // staged x row: j0-4 .. j0+PW+3
  static constexpr int XROWS = PR + 2;
  static constexpr int LDX = XROWS * XW + 4; // 4 mod 8: conflict-free b
  static constexpr int X_OFF = 2 * BM * LDA;
  static constexpr int SD = X_OFF + BN * LDX;   // d, then s
  static constexpr int STAGE = SD + BM + BN;
  static constexpr int SMEM = STAGES * STAGE * 4;   // bytes
  static_assert(PW % 8 == 0 && PIX % PW == 0, "k steps of 8 in a row");
  static_assert(XW % 4 == 0 && LDX % 8 == 4, "conflict-free b fragments");
  static_assert(BM * OUT_LD <= STAGES * STAGE, "epilogue fits");
  static_assert(SMEM <= 232448, "fits one block's shared memory");
};

struct Unit {
  int n, i0, j0;   // sample, top-left pixel of the chunk
};

// Unit u of the (n, chunk row, chunk column) order that the plan splits.
template <int PW>
__device__ __forceinline__ Unit unit_at(long long u, int rows, int cols) {
  const long long chunks = static_cast<long long>(rows) * cols;
  const int rc = static_cast<int>(u % chunks);
  return {static_cast<int>(u / chunks), (rc / cols) * Geometry<PW>::PR,
          (rc % cols) * PW};
}

// Stage one unit's dy and y [BM][PIX], haloed x [BN][XROWS][XW] and its
// sample's d and s slices into `st` with cp.async (not waited for here).
// A thread copies the dy and y float4s at one pixel slot p4 = tid % (PIX/4)
// of rows tid / (PIX/4) + k * (THREADS / (PIX/4)): the float4s that
// split_dz later rewrites, so that pass needs no barrier.
template <int PW, bool VEC>
__device__ __forceinline__ void load_chunk(
    float* st, const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ d, Unit un, int co0, int ci0, int CI, int CO,
    int H, int W) {
  using G = Geometry<PW>;
  if (threadIdx.x < BM + BN) {
    const bool is_d = threadIdx.x < BM;
    const int c = is_d ? co0 + threadIdx.x : ci0 + threadIdx.x - BM;
    const bool ok = c < (is_d ? CO : CI);
    const long long off =
        ok ? static_cast<long long>(un.n) * (is_d ? CO : CI) + c : 0;
    cp_async4(st + G::SD + threadIdx.x, (is_d ? d : s) + off, ok);
  }
  const long long plane = static_cast<long long>(H) * W;
  {
    constexpr int P4 = PIX / 4;
    const int p4 = threadIdx.x % P4;
    const int gi = un.i0 + 4 * p4 / PW;
    const int gj = un.j0 + 4 * p4 % PW;
    const long long pix = static_cast<long long>(gi) * W + gj;
    for (int cl = threadIdx.x / P4; cl < BM; cl += DW_THREADS / P4) {
      const int co = co0 + cl;
      const bool row_ok = co < CO && gi < H;
      const long long off =
          (static_cast<long long>(un.n) * CO + co) * plane + pix;
      float* dst = st + cl * LDA + 4 * p4;
      if (VEC) {
        // W % 4 == 0: the 4 pixels are wholly inside the plane or outside
        const bool ok = row_ok && gj < W;
        cp_async16(dst, dy + (ok ? off : 0), ok);
        cp_async16(dst + BM * LDA, y + (ok ? off : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok && gj + e < W;
          cp_async4(dst + e, dy + (ok ? off + e : 0), ok);
          cp_async4(dst + BM * LDA + e, y + (ok ? off + e : 0), ok);
        }
      }
    }
  }
  // x: a thread keeps one (row, column group) of the haloed chunk and
  // walks the channels
  constexpr int V = VEC ? 4 : 1;      // floats a copy moves
  constexpr int XQ = G::XW / V;
  constexpr int RQ = G::XROWS * XQ;   // copies of a channel
  constexpr int TPG = RQ >= DW_THREADS ? DW_THREADS : pow2_at_least(RQ);
  for (int rq = threadIdx.x % TPG; rq < RQ; rq += TPG) {
    const int r = rq / XQ;
    const int gi = un.i0 + r - 1;
    const int gj = un.j0 - 4 + V * (rq % XQ);
    const bool px_ok = gi >= 0 && gi < H && gj >= 0 && gj < W;
    const long long pix = static_cast<long long>(gi) * W + gj;
    float* dst = st + G::X_OFF + r * G::XW + V * (rq % XQ);
    for (int cl = threadIdx.x / TPG; cl < BN; cl += DW_THREADS / TPG) {
      const bool ok = px_ok && ci0 + cl < CI;
      const long long off =
          ok ? (static_cast<long long>(un.n) * CI + ci0 + cl) * plane + pix
             : 0;
      if (VEC)
        cp_async16(dst + cl * G::LDX, x + off, ok);
      else
        cp_async4(dst + cl * G::LDX, x + off, ok);
    }
  }
}

// dz = dy * g(y) over the float4s of dy and y that this thread staged,
// split in place: big over dy, small over y (zero-filled dy stays 0
// whatever g(y)).
__device__ __forceinline__ void split_dz(float* st, float gain, float clamp,
                                         int has_clamp) {
  constexpr int P4 = PIX / 4;
  const int p4 = threadIdx.x % P4;
  for (int cl = threadIdx.x / P4; cl < BM; cl += DW_THREADS / P4) {
    float4* big = reinterpret_cast<float4*>(st + cl * LDA) + p4;
    float4* small = reinterpret_cast<float4*>(st + (BM + cl) * LDA) + p4;
    const float4 dv = *big, yv = *small;
    const float dz[4] = {dv.x * act_grad(yv.x, gain, clamp, has_clamp),
                         dv.y * act_grad(yv.y, gain, clamp, has_clamp),
                         dv.z * act_grad(yv.z, gain, clamp, has_clamp),
                         dv.w * act_grad(yv.w, gain, clamp, has_clamp)};
    uint32_t b[4], sm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(dz[i], b[i], sm[i]);
    *reinterpret_cast<uint4*>(big) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// The warp's 32 co x 8 ci x 9 taps over one staged chunk, scaled by the
// sample's d[co] * s[ci] and added to acc. The tensor cores' fp32 sums
// truncate, which shrinks a sum by a share that grows with the number of
// MMAs it passes through (on the large planes, past the 1e-5 gate when
// one fragment held a block's whole K range), so each chunk (48 MMAs a
// fragment) starts from zero and is added to acc in round-to-nearest fp32
// FMAs.
template <int PW>
__device__ __forceinline__ void mma_chunk(const float* st,
                                          float (&acc)[9][MT][4], Unit un,
                                          int H, int W) {
  using G = Geometry<PW>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in the group
  // a (16 co x 8 px, row-major): rows g and g+8, columns t and t+4
  const float* aw = st + ((warp / WARPS_N) * WM + g) * LDA + t;
  // b (8 px x 8 ci, column-major): column g (ci), rows t and t+4 (px);
  // staged column 3 is the halo column j0-1
  const float* bw = st + G::X_OFF + ((warp % WARPS_N) * WN + g) * G::LDX +
                   t + 3;
  float part[9][MT][4];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[a][b][c] = 0.0f;
  // Walk each 8-column group down the chunk's rows. Tap (di, dj) of k row
  // kr reads staged x row kr + di, so consecutive k rows share two of
  // their three x rows: each x row's b fragments (its three dj shifts) are
  // split once and kept in a 3-row window of registers.
#pragma unroll
  for (int kc = 0; kc < PW / 8; ++kc) {
    if (un.j0 + 8 * kc >= W) break;
    uint32_t wb[3][3][2], ws[3][3][2];   // [row % 3][dj][fragment register]
    const auto load_row = [&](int r) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const float* p = bw + r * G::XW + 8 * kc + dj;
        split_tf32(p[0], wb[r % 3][dj][0], ws[r % 3][dj][0]);
        split_tf32(p[4], wb[r % 3][dj][1], ws[r % 3][dj][1]);
      }
    };
    load_row(0);
    load_row(1);
#pragma unroll
    for (int kr = 0; kr < G::PR; ++kr) {
      if (un.i0 + kr >= H) break;
      load_row(kr + 2);
      const int k0 = kr * PW + 8 * kc;
      // dz's big and small halves, split once per chunk by split_dz
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(aw) +
                            mt * 16 * LDA + k0;
        const int off[4] = {0, 8 * LDA, 4, 8 * LDA + 4};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[mt][i] = p[off[i]];
          as[mt][i] = p[off[i] + BM * LDA];
        }
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t(&bb)[2] = wb[(kr + tap / 3) % 3][tap % 3];
        const uint32_t(&bs)[2] = ws[(kr + tap / 3) % 3][tap % 3];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[tap][mt], as[mt], bb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[tap][mt], ab[mt], bs);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[tap][mt], ab[mt], bb);
      }
    }
  }
  // accumulator c of fragment mt: co row g + 8 * (c / 2), ci column
  // 2t + c % 2
  const float* dv = st + G::SD + (warp / WARPS_N) * WM + g;
  const float* sv = st + G::SD + BM + (warp % WARPS_N) * WN + 2 * t;
  float ds[MT][4];
#pragma unroll
  for (int b = 0; b < MT; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) ds[b][c] = dv[16 * b + 8 * (c / 2)] * sv[c % 2];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[a][b][c] = fmaf(ds[b][c], part[a][b][c], acc[a][b][c]);
}

template <int PW, bool VEC>
__global__ void __launch_bounds__(DW_THREADS, 1)
modconv_dw_tc_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                     const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ d, float* __restrict__ partial,
                     int N, int CI, int CO, int H, int W, float gain,
                     float clamp, int has_clamp) {
  using G = Geometry<PW>;
  extern __shared__ __align__(16) float smem[];
  const int co0 = blockIdx.x * BM;
  const int ci0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int rows = (H + G::PR - 1) / G::PR;
  const int cols = (W + PW - 1) / PW;
  // this split's units [u_begin, u_end): bwd_weight_plan's ranges
  const long long units = static_cast<long long>(N) * rows * cols;
  const long long u_begin = units * split / gridDim.z;
  const int count = static_cast<int>(units * (split + 1) / gridDim.z - u_begin);

  float acc[9][MT][4];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count)
      load_chunk<PW, VEC>(smem + i * G::STAGE, dy, y, x, s, d,
                          unit_at<PW>(u_begin + i, rows, cols), co0, ci0, CI,
                          CO, H, W);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    float* st = smem + (i % STAGES) * G::STAGE;
    cp_async_wait<STAGES - 2>();
    split_dz(st, gain, clamp, has_clamp);
    // chunk i has landed for every thread and dz is split, and every warp
    // is done with chunk i-1, whose stage the next copy fills
    __syncthreads();
    const int next = i + STAGES - 1;
    if (next < count)
      load_chunk<PW, VEC>(smem + (next % STAGES) * G::STAGE, dy, y, x, s, d,
                          unit_at<PW>(u_begin + next, rows, cols), co0, ci0,
                          CI, CO, H, W);
    cp_async_commit();
    mma_chunk<PW>(st, acc, unit_at<PW>(u_begin + i, rows, cols), H, W);
  }
  cp_async_wait<0>();
  __syncthreads();

  // accumulators -> shared [co][ci * 9 + tap] -> coalesced partial rows
  {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ci_l = (warp % WARPS_N) * WN + 2 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int co_l = (warp / WARPS_N) * WM + mt * 16 + g;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        smem[co_l * OUT_LD + ci_l * 9 + tap] = acc[tap][mt][0];
        smem[co_l * OUT_LD + (ci_l + 1) * 9 + tap] = acc[tap][mt][1];
        smem[(co_l + 8) * OUT_LD + ci_l * 9 + tap] = acc[tap][mt][2];
        smem[(co_l + 8) * OUT_LD + (ci_l + 1) * 9 + tap] = acc[tap][mt][3];
      }
    }
  }
  __syncthreads();
  const int row_len = min(BN, CI - ci0) * 9;
  for (int idx = threadIdx.x; idx < BM * BN * 9; idx += DW_THREADS) {
    const int cl = idx / (BN * 9);
    const int j = idx % (BN * 9);
    const int co = co0 + cl;
    if (co < CO && j < row_len)
      partial[(static_cast<long long>(split) * CO + co) * CI * 9 +
              static_cast<long long>(ci0) * 9 + j] = smem[cl * OUT_LD + j];
  }
}

template <int PW, bool VEC>
int launch(const float* dy, const float* y, const float* x, const float* s,
           const float* d, float* partial, int N, int CI, int CO, int H, int W,
           float gain, float clamp, int has_clamp, int splits,
           cudaStream_t stream) {
  auto kernel = modconv_dw_tc_kernel<PW, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geometry<PW>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((CO + BM - 1) / BM, (CI + BN - 1) / BN, splits);
  kernel<<<grid, DW_THREADS, Geometry<PW>::SMEM, stream>>>(
      dy, y, x, s, d, partial, N, CI, CO, H, W, gain, clamp, has_clamp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dy, y [N,CO,H,W], x [N,CI,H,W], s [N,CI], d [N,CO] -> partial
// [splits,CO,CI,9], whose sum over the first axis is dW's direct term
// [CO,CI,3,3]. All float32, contiguous, on the current device. chunk_cols
// (8 or 16) and splits come from the wrapper's plan; vec != 0 promises
// W % 4 == 0 and 16-byte aligned dy, y and x. Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int stylemc_modconv_bwd_weight(const void* dy, const void* y,
                                          const void* x, const void* s,
                                          const void* d, void* partial, int N,
                                          int CI, int CO, int H, int W,
                                          float gain, float clamp,
                                          int has_clamp, int splits,
                                          int chunk_cols, int vec,
                                          void* stream) {
  if (N <= 0 || CI <= 0 || CO <= 0 || H <= 0 || W <= 0 || splits <= 0) return 0;
  const auto args = [&](auto fn) {
    return fn(static_cast<const float*>(dy), static_cast<const float*>(y),
              static_cast<const float*>(x), static_cast<const float*>(s),
              static_cast<const float*>(d), static_cast<float*>(partial), N,
              CI, CO, H, W, gain, clamp, has_clamp, splits,
              static_cast<cudaStream_t>(stream));
  };
  if (chunk_cols == 16)
    return vec ? args(launch<16, true>) : args(launch<16, false>);
  if (chunk_cols == 8)
    return vec ? args(launch<8, true>) : args(launch<8, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}
