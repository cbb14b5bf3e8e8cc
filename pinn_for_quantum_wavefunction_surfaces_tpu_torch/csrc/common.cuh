// Helpers shared by the port's kernels: type-generic math and the packed
// weight layout of one width-H MLP 2 -> H -> H -> 1.
#pragma once

#include <cuda_runtime.h>

namespace kern {

__device__ __forceinline__ float m_tanh(float v) { return tanhf(v); }
__device__ __forceinline__ double m_tanh(double v) { return tanh(v); }
__device__ __forceinline__ float m_exp(float v) { return expf(v); }
__device__ __forceinline__ double m_exp(double v) { return exp(v); }
__device__ __forceinline__ float m_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double m_sqrt(double v) { return sqrt(v); }

// Weights of one MLP, packed row-major as the wrappers concatenate them:
// w1 (2,H) | b1 (H) | w2 (H,H) | b2 (H) | ow (H) | ob (1).
template <int H>
struct Layout {
  static constexpr int W1 = 0;
  static constexpr int B1 = 2 * H;
  static constexpr int W2 = 3 * H;
  static constexpr int B2 = 3 * H + H * H;
  static constexpr int OW = 4 * H + H * H;
  static constexpr int OB = 5 * H + H * H;
  static constexpr int SIZE = H * H + 5 * H + 1;
};

}  // namespace kern
