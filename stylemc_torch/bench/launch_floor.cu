// The launch floor: an empty kernel, one block of 32 threads that does
// nothing. Timed as every kernel row of chip_smoke.py is timed (device time
// between CUDA events around launches queued behind a sleep kernel), it is
// what one launch costs on the card before a byte moves: the floor under
// B1 and B2 (ops/kernels/csrc/upsample2x.cu, downsample2x.cu) on the small
// planes of the ToRGB chain, beside their byte bounds. No path of the port
// runs it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches the empty kernel on `stream`; returns cudaGetLastError().
extern "C" int stylemc_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
