// Helpers shared by the port's kernels: storage and compute types,
// type-generic math and the packed weight layout of one width-H MLP
// 2 -> H -> H -> 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace kern {

// A kernel is instantiated for a storage type S, the type of its tensors
// in device memory, and computes in compute_t<S>: S itself for float and
// double; float for __nv_bfloat16, whose builds load each value once into
// float, run the float32 build's arithmetic, and round each output once
// (ld, st). For S = T both are the identity, so the float32 and float64
// builds compile to the same code as without them.
template <typename S>
struct Compute {
  using type = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using compute_t = typename Compute<S>::type;

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ double ld(double v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S>
__device__ __forceinline__ S st(compute_t<S> v) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// The type codes of the C entry points' queries (occupancy, points a
// tile): 0 float32, 1 float64, 2 bfloat16 (ops/_cuda.py type_code).
enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2 };

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

constexpr unsigned kFull = 0xffffffffu;

// Sum over the lanes of a warp of each of the calling thread's C values
// (lanes OFF, 2 OFF, ... apart hold the same units), by recursive halving:
// at each level a lane keeps half its values, adds its partner's half of
// them and passes the other half on, so the C values cost C - 1 exchanges;
// the levels past one value add whole values. v[0] ends as the warp's sum
// of the value in the returned slot. The order of every sum is fixed.
template <int C, int OFF, typename T>
__device__ __forceinline__ int warp_unit_sum(T* v, int lane) {
  if constexpr (C > 1) {
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const T send = up ? v[j] : v[j + C / 2];
      const T keep = up ? v[j + C / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    return (up ? C / 2 : 0) + warp_unit_sum<C / 2, OFF * 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off < 32; off <<= 1)
      v[0] += __shfl_xor_sync(kFull, v[0], off);
    return 0;
  }
}

// The warp's sums over its lanes of C consecutive units' values v (one
// point a lane), added by the owner lanes (0 .. C - 1) to sums[unit].
template <int C>
__device__ __forceinline__ void add_warp_sums(float* v, float* sums,
                                              int lane) {
  const int slot = warp_unit_sum<C, 1>(v, lane);
  if (lane < C) sums[slot] += v[0];
}

// Four floats to and from 16-byte aligned shared memory in one access.
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void load4(const float* src, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Adjoint of the scalar geometry of one pair of nuclei at (+-R, +-ry, +-rz)
// (the backward kernels' point-gradient instantiations; the plain version
// is ops/pallas_separable.geometry_vjp). For the displacements
// d1 = (xs - R, y - ry, z - rz) and d2 = (xs + R, y + ry, z + rz), with
// inverse radii i1, i2 and c12 = u1.u2 (u_i = d_i i_i), it carries the
// cotangents of r1, r2 and c12 to xs, y, z and R: dr_i/dd_i = u_i,
// dc12/dd1 = (u2 - c12 u1) i1 and the mirror image for d2. (The symmetric
// family's mirrored branch passes xs = -x and negates dxs.)
template <typename T>
__device__ __forceinline__ void geometry_adjoint(T xs, T y, T z, T R, T ry,
                                                 T rz, T i1, T i2, T c12,
                                                 T dr1, T dr2, T dc12, T& dxs,
                                                 T& dy, T& dz, T& dR) {
  const T u1x = (xs - R) * i1, u1y = (y - ry) * i1, u1z = (z - rz) * i1;
  const T u2x = (xs + R) * i2, u2y = (y + ry) * i2, u2z = (z + rz) * i2;
  const T k1 = dc12 * i1, k2 = dc12 * i2;
  const T g1x = dr1 * u1x + k1 * (u2x - c12 * u1x);
  const T g1y = dr1 * u1y + k1 * (u2y - c12 * u1y);
  const T g1z = dr1 * u1z + k1 * (u2z - c12 * u1z);
  const T g2x = dr2 * u2x + k2 * (u1x - c12 * u2x);
  const T g2y = dr2 * u2y + k2 * (u1y - c12 * u2y);
  const T g2z = dr2 * u2z + k2 * (u1z - c12 * u2z);
  dxs = g1x + g2x;
  dy = g1y + g2y;
  dz = g1z + g2z;
  dR = g2x - g1x;
}

}  // namespace kern
