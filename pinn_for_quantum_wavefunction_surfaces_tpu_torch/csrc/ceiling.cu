// Measurement kernels of the bench line's roofline denominator (bench.py,
// measure_ceilings): the float32 ceilings of the card's CUDA cores outside
// the tensor cores. They replace no TPU kernel; the plain versions are
// ops/ceiling.py's.
//
// - fma chain: every thread runs kChains independent chains of
//   x <- fmaf(x, a, b), kUnrollFma dependent steps per loop iteration; the
//   chains give each warp independent FMAs to issue back to back, and many
//   resident warps hide the FMA latency, so the chain is bound by the FMA
//   pipes (2 FLOP a step), not by memory: one read and one write a thread.
// - tanh chain: x <- tanhf(x * a), kUnrollTanh steps an iteration, one
//   transcendental (and one multiply) a step.
//
// a and b are kernel arguments and each thread writes the sum of its
// chains, so the compiler can neither fold a chain nor drop it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kUnrollFma = 16;
constexpr int kUnrollTanh = 4;

__global__ void __launch_bounds__(kThreads)
    ceiling_fma_kernel(const float* __restrict__ x0, float* __restrict__ out,
                       int n, int iters, float a, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[kChains];
  const float x = x0[i];
#pragma unroll
  for (int c = 0; c < kChains; ++c) v[c] = x + 1e-3f * c;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnrollFma; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) v[c] = fmaf(v[c], a, b);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += v[c];
  out[i] = s;
}

__global__ void __launch_bounds__(kThreads)
    ceiling_tanh_kernel(const float* __restrict__ x0, float* __restrict__ out,
                        int n, int iters, float a, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[kChains];
  const float x = x0[i];
#pragma unroll
  for (int c = 0; c < kChains; ++c) v[c] = x + 1e-3f * c;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnrollTanh; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) v[c] = tanhf(v[c] * a);
    }
  }
  float s = b;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += v[c];
  out[i] = s;
}

int launch(bool tanh_chain, const void* x0, void* out, int n, int iters,
           float a, float b, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x0);
  auto* op = static_cast<float*>(out);
  if (tanh_chain)
    ceiling_tanh_kernel<<<blocks, kThreads, 0, s>>>(xp, op, n, iters, a, b);
  else
    ceiling_fma_kernel<<<blocks, kThreads, 0, s>>>(xp, op, n, iters, a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ceiling_fma_f32(const void* x0, void* out, int n, int iters,
                               float a, float b, void* stream) {
  return launch(false, x0, out, n, iters, a, b, stream);
}

extern "C" int ceiling_tanh_f32(const void* x0, void* out, int n, int iters,
                                float a, float b, void* stream) {
  return launch(true, x0, out, n, iters, a, b, stream);
}

// The chain shape the wrapper counts operations with: 0 chains a thread,
// 1 FMA steps an iteration, 2 tanh steps an iteration; -1 otherwise.
extern "C" int ceiling_shape(int which) {
  switch (which) {
    case 0:
      return kChains;
    case 1:
      return kUnrollFma;
    case 2:
      return kUnrollTanh;
    default:
      return -1;
  }
}

extern "C" const char* ceiling_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
