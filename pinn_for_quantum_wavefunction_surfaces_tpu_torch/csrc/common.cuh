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
