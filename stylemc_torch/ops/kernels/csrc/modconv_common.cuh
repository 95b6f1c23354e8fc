// Shared by the fused synthesis layer's backward kernels
// (modconv_bwd_data.cu, modconv_bwd_weight.cu): the lrelu/clamp gradient
// rule, read off the layer's saved output.

#pragma once

#include <cuda_runtime.h>

namespace modconv {

constexpr float LRELU_SLOPE = 0.2f;

// d(clamp(lrelu(z) * gain)) / dz, read off the output y: 0 where the clamp
// binds (|y| >= clamp), else gain or gain * 0.2 by the sign of y.
__device__ __forceinline__ float act_grad(float y, float gain, float clamp,
                                          int has_clamp) {
  if (has_clamp && fabsf(y) >= clamp) return 0.0f;
  return y >= 0.0f ? gain : gain * LRELU_SLOPE;
}

}  // namespace modconv
