// Per-point arithmetic shared by the symmetric-family (psi, lap psi) kernels
// (K2: train_fwd.cu, train_bwd.cu).
//
// One CUDA thread evaluates one point. The arithmetic is the same, step for
// step, as the plain PyTorch versions in ops/pallas_train.py
// (psi_lap_train_plain and psi_lap_train_vjp_plain), which the CPU tests
// hold against the JAX package.
//
// The formulation. A branch of the ansatz is the sigmoid MLP 2 -> H -> H -> 1
// on the envelopes f1 = e^{-a r1}, f2 = e^{-a r2}; the mirrored branch is the
// same MLP on the geometry mirrored at x -> -x (the laplacian does not see
// the mirror). The gradient of an envelope is -a f u, u the unit vector from
// its nucleus, so every spatial gradient inside a branch lies in span{u1,
// u2} and is carried as two coefficients: |c1 u1 + c2 u2|^2 = c1^2 + c2^2 +
// 2 c1 c2 (u1.u2). Each hidden unit is then the 4-stack (value, c1, c2,
// laplacian) instead of the 5-stack (value, gx, gy, gz, laplacian) of the
// JAX kernel.
//
// Weight layout (one MLP, kern::Layout): w1 (2,H) | b1 (H) | w2 (H,H) |
// b2 (H) | ow (H) | ob (1).
#pragma once

#include "common.cuh"

namespace trn {

using kern::Layout;
using kern::m_exp;
using kern::m_sqrt;

template <typename T>
__device__ __forceinline__ T m_sigmoid(T v) {
  return T(1) / (T(1) + m_exp(-v));
}

// Geometry of one branch and its two envelope stacks: value f, gradient
// coefficient g = -a f on the unit vector, laplacian l = f (a^2 - 2a/r).
template <typename T>
struct Env {
  T r1, r2, i1, i2, c12;
  T f1, g1, l1, f2, g2, l2;
};

template <typename T>
__device__ __forceinline__ void envelopes(T dx1, T dy1, T dz1, T dx2, T dy2,
                                          T dz2, T a, Env<T>& e) {
  e.r1 = m_sqrt(dx1 * dx1 + dy1 * dy1 + dz1 * dz1);
  e.r2 = m_sqrt(dx2 * dx2 + dy2 * dy2 + dz2 * dz2);
  e.i1 = T(1) / e.r1;
  e.i2 = T(1) / e.r2;
  e.c12 = (dx1 * dx2 + dy1 * dy2 + dz1 * dz2) * e.i1 * e.i2;
  e.f1 = m_exp(-a * e.r1);
  e.g1 = -a * e.f1;
  e.l1 = e.f1 * (a * a - T(2) * a * e.i1);
  e.f2 = m_exp(-a * e.r2);
  e.g2 = -a * e.f2;
  e.l2 = e.f2 * (a * a - T(2) * a * e.i2);
}

// The direct branch at (x -+ R, y -+ ry, z -+ rz) and the mirrored one at
// (-x -+ R, ...).
template <typename T>
__device__ __forceinline__ void branch_envelopes(T x, T y, T z, T r, T ry,
                                                 T rz, T a, bool mirror,
                                                 Env<T>& e) {
  const T xs = mirror ? -x : x;
  envelopes(xs - r, y - ry, z - rz, xs + r, y + ry, z + rz, a, e);
}

// First-layer unit j: sigmoid s(z) and its derivatives, the gradient
// coefficients (ga, gb) and laplacian lz of its pre-activation, and
// q = |grad z|^2.
template <typename T>
struct Unit1 {
  T s, d1, d2, ga, gb, lz, q;
};

template <typename T, int H>
__device__ __forceinline__ Unit1<T> unit1(const T* W, int j, const Env<T>& e) {
  using L = Layout<H>;
  const T w0 = W[L::W1 + j];
  const T w1 = W[L::W1 + H + j];
  Unit1<T> u;
  const T z = e.f1 * w0 + e.f2 * w1 + W[L::B1 + j];
  u.ga = e.g1 * w0;
  u.gb = e.g2 * w1;
  u.lz = e.l1 * w0 + e.l2 * w1;
  u.s = m_sigmoid(z);
  u.d1 = u.s * (T(1) - u.s);
  u.d2 = u.d1 * (T(1) - T(2) * u.s);
  u.q = u.ga * u.ga + u.gb * u.gb + T(2) * e.c12 * u.ga * u.gb;
  return u;
}

// First layer: the 4-stacks (a0, a1, a2, a3) = (s, d1 ga, d1 gb,
// d1 lz + d2 q) of every unit.
template <typename T, int H>
__device__ __forceinline__ void layer1(const T* W, const Env<T>& e,
                                       T (&a0)[H], T (&a1)[H], T (&a2)[H],
                                       T (&a3)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const Unit1<T> u = unit1<T, H>(W, j, e);
    a0[j] = u.s;
    a1[j] = u.d1 * u.ga;
    a2[j] = u.d1 * u.gb;
    a3[j] = u.d1 * u.lz + u.d2 * u.q;
  }
}

// Second-layer unit k: pre-activation stack (p0..p3), sigmoid s and its
// derivatives e1, e2, qq = |grad p|^2, and the unit's value bv and
// laplacian bl.
template <typename T>
struct Unit2 {
  T p0, p1, p2, p3, s, e1, e2, qq, bv, bl;
};

template <typename T, int H>
__device__ __forceinline__ Unit2<T> unit2(const T* W, int k, const Env<T>& e,
                                          const T (&a0)[H], const T (&a1)[H],
                                          const T (&a2)[H],
                                          const T (&a3)[H]) {
  using L = Layout<H>;
  Unit2<T> u;
  u.p0 = T(0);
  u.p1 = T(0);
  u.p2 = T(0);
  u.p3 = T(0);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T w = W[L::W2 + i * H + k];
    u.p0 += a0[i] * w;
    u.p1 += a1[i] * w;
    u.p2 += a2[i] * w;
    u.p3 += a3[i] * w;
  }
  u.p0 += W[L::B2 + k];
  u.s = m_sigmoid(u.p0);
  u.e1 = u.s * (T(1) - u.s);
  u.e2 = u.e1 * (T(1) - T(2) * u.s);
  u.qq = u.p1 * u.p1 + u.p2 * u.p2 + T(2) * e.c12 * u.p1 * u.p2;
  u.bv = u.s;
  u.bl = u.e1 * u.p3 + u.e2 * u.qq;
  return u;
}

// (value, laplacian) of one branch's output ow . B (no output bias).
template <typename T, int H>
__device__ __forceinline__ void branch_fwd(const T* W, const Env<T>& e, T& ov,
                                           T& ol) {
  using L = Layout<H>;
  T a0[H], a1[H], a2[H], a3[H];
  layer1<T, H>(W, e, a0, a1, a2, a3);
  ov = T(0);
  ol = T(0);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const Unit2<T> u = unit2<T, H>(W, k, e, a0, a1, a2, a3);
    ov += u.bv * W[L::OW + k];
    ol += u.bl * W[L::OW + k];
  }
}

// The Guillemin-Zener pair on the direct geometry: v1 = e^{-a r1 - b r2}
// with laplacian v1 s1, v2 = e^{-a r2 - b r1} with laplacian v2 s2 (LCAO
// is b = 0).
template <typename T>
struct GZ {
  T v1, s1, v2, s2;
};

template <typename T>
__device__ __forceinline__ GZ<T> gz(T a, T b, const Env<T>& e) {
  GZ<T> g;
  const T base = a * a + b * b + T(2) * a * b * e.c12;
  g.v1 = m_exp(-a * e.r1 - b * e.r2);
  g.s1 = base - T(2) * a * e.i1 - T(2) * b * e.i2;
  g.v2 = m_exp(-a * e.r2 - b * e.r1);
  g.s2 = base - T(2) * a * e.i2 - T(2) * b * e.i1;
  return g;
}

// Adjoint of psi += v1 + P v2, lap += v1 s1 + P v2 s2 in (a, b).
template <typename T>
__device__ __forceinline__ void gz_adjoint(T a, T b, T psym, const Env<T>& e,
                                           T dpsi, T dlap, T& da, T& db) {
  const GZ<T> g = gz(a, b, e);
  const T dv1 = dpsi + dlap * g.s1;
  const T ds1 = dlap * g.v1;
  const T dv2 = psym * (dpsi + dlap * g.s2);
  const T ds2 = psym * dlap * g.v2;
  const T sa = T(2) * a + T(2) * b * e.c12;
  const T sb = T(2) * b + T(2) * a * e.c12;
  da += -e.r1 * g.v1 * dv1 + ds1 * (sa - T(2) * e.i1) -
        e.r2 * g.v2 * dv2 + ds2 * (sa - T(2) * e.i2);
  db += -e.r2 * g.v1 * dv1 + ds1 * (sb - T(2) * e.i2) -
        e.r1 * g.v2 * dv2 + ds2 * (sb - T(2) * e.i1);
}

// Forward and adjoint of one branch for output cotangents (cv, cl) on its
// (value, laplacian), staging this thread's terms of the weight-gradient
// sums in column ``tid`` of the shared buffers (row stride LD):
//   sA [4H] the first-layer stacks (a0..a3),
//   sG [4H] the cotangents of the second-layer pre-activation stacks,
//   sD [H]  the output-weight terms, sE [3H] the first-layer terms (w1 row
//           0, w1 row 1, b1); these two add to what ``first`` == false
//           finds there (the other branch's terms).
// Returns the branch's cotangent of the exponent a; (ov, ol) is its output.
template <typename T, int H, int LD>
__device__ __forceinline__ T branch_stage(const T* W, const Env<T>& e, T a,
                                          T cv, T cl, int tid, bool first,
                                          T* sA, T* sG, T* sD, T* sE, T& ov,
                                          T& ol) {
  using L = Layout<H>;
  T a0[H], a1[H], a2[H], a3[H];
  layer1<T, H>(W, e, a0, a1, a2, a3);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    sA[j * LD + tid] = a0[j];
    sA[(H + j) * LD + tid] = a1[j];
    sA[(2 * H + j) * LD + tid] = a2[j];
    sA[(3 * H + j) * LD + tid] = a3[j];
  }
  ov = T(0);
  ol = T(0);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const Unit2<T> u = unit2<T, H>(W, k, e, a0, a1, a2, a3);
    const T owk = W[L::OW + k];
    ov += u.bv * owk;
    ol += u.bl * owk;
    const T cd = cv * u.bv + cl * u.bl;
    sD[k * LD + tid] = first ? cd : sD[k * LD + tid] + cd;
    // bv = s(p0), bl = e1(p0) p3 + e2(p0) qq, qq = p1^2 + p2^2 + 2 c12 p1 p2
    const T dbv = cv * owk;
    const T dbl = cl * owk;
    const T e3 = u.e2 * (T(1) - T(2) * u.s) - T(2) * u.e1 * u.e1;
    const T dq = dbl * u.e2;
    sG[k * LD + tid] = dbv * u.e1 + dbl * (u.e2 * u.p3 + e3 * u.qq);
    sG[(H + k) * LD + tid] = dq * (T(2) * u.p1 + T(2) * e.c12 * u.p2);
    sG[(2 * H + k) * LD + tid] = dq * (T(2) * u.p2 + T(2) * e.c12 * u.p1);
    sG[(3 * H + k) * LD + tid] = dbl * u.e1;
  }
  // first layer: cotangents of the stacks, then of z, (ga, gb), lz
  T df1 = T(0), dg1 = T(0), dl1 = T(0), df2 = T(0), dg2 = T(0), dl2 = T(0);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    T da0 = T(0), da1 = T(0), da2 = T(0), da3 = T(0);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const T w = W[L::W2 + i * H + k];
      da0 += sG[k * LD + tid] * w;
      da1 += sG[(H + k) * LD + tid] * w;
      da2 += sG[(2 * H + k) * LD + tid] * w;
      da3 += sG[(3 * H + k) * LD + tid] * w;
    }
    const Unit1<T> u = unit1<T, H>(W, i, e);
    const T d3 = u.d2 * (T(1) - T(2) * u.s) - T(2) * u.d1 * u.d1;
    const T dz = da0 * u.d1 + (da1 * u.ga + da2 * u.gb + da3 * u.lz) * u.d2 +
                 da3 * u.q * d3;
    const T dga = da1 * u.d1 + da3 * u.d2 * (T(2) * u.ga + T(2) * e.c12 * u.gb);
    const T dgb = da2 * u.d1 + da3 * u.d2 * (T(2) * u.gb + T(2) * e.c12 * u.ga);
    const T dlz = da3 * u.d1;
    const T c0 = dz * e.f1 + dga * e.g1 + dlz * e.l1;
    const T c1 = dz * e.f2 + dgb * e.g2 + dlz * e.l2;
    T* e0 = sE + i * LD + tid;
    T* e1 = sE + (H + i) * LD + tid;
    T* e2 = sE + (2 * H + i) * LD + tid;
    *e0 = first ? c0 : *e0 + c0;
    *e1 = first ? c1 : *e1 + c1;
    *e2 = first ? dz : *e2 + dz;
    const T w0 = W[L::W1 + i];
    const T w1 = W[L::W1 + H + i];
    df1 += dz * w0;
    dg1 += dga * w0;
    dl1 += dlz * w0;
    df2 += dz * w1;
    dg2 += dgb * w1;
    dl2 += dlz * w1;
  }
  // f = e^{-a r}: df/da = -r f; g = -a f: dg/da = a r f - f;
  // l = f (a^2 - 2a/r): dl/da = f (2a - 2/r) - r l
  return df1 * (-e.r1 * e.f1) + dg1 * (a * e.r1 * e.f1 - e.f1) +
         dl1 * (e.f1 * (T(2) * a - T(2) * e.i1) - e.r1 * e.l1) +
         df2 * (-e.r2 * e.f2) + dg2 * (a * e.r2 * e.f2 - e.f2) +
         dl2 * (e.f2 * (T(2) * a - T(2) * e.i2) - e.r2 * e.l2);
}

// Sum over a block's P points, in order, of one branch's terms of the
// second-layer gradients: o < H^2 is w2[i][k], then b2[k].
template <typename T, int H, int P, int LD>
__device__ __forceinline__ T reduce_layer2(int o, const T* sA, const T* sG) {
  T acc = T(0);
  if (o < H * H) {
    const int i = o / H, k = o % H;
    for (int p = 0; p < P; ++p)
      acc += sA[i * LD + p] * sG[k * LD + p] +
             sA[(H + i) * LD + p] * sG[(H + k) * LD + p] +
             sA[(2 * H + i) * LD + p] * sG[(2 * H + k) * LD + p] +
             sA[(3 * H + i) * LD + p] * sG[(3 * H + k) * LD + p];
  } else {
    const int k = o - H * H;
    for (int p = 0; p < P; ++p) acc += sG[k * LD + p];
  }
  return acc;
}

// The block's partial of packed weight o: w1 and b1 from sE, w2 and b2
// from the per-branch sums sacc, ow from sD, ob from sC (the value
// cotangents).
template <typename T, int H, int P, int LD>
__device__ __forceinline__ T reduce_packed(int o, const T* sacc, const T* sD,
                                           const T* sE, const T* sC) {
  using L = Layout<H>;
  if (o >= L::W2 && o < L::OW) return sacc[o - L::W2];
  T acc = T(0);
  if (o < L::W2) {
    for (int p = 0; p < P; ++p) acc += sE[o * LD + p];
  } else if (o < L::OB) {
    for (int p = 0; p < P; ++p) acc += sD[(o - L::OW) * LD + p];
  } else {
    for (int p = 0; p < P; ++p) acc += sC[p];
  }
  return acc;
}

}  // namespace trn

// C entry points return cudaGetLastError() of their launch; this names it.
extern "C" const char* train_error_string(int err);
