// Per-point arithmetic shared by the symmetric-family (psi, lap psi) kernels:
// K2 (train_fwd.cu, train_bwd.cu, and train_tile.cuh for float64) and K3
// (residual_fwd.cu).
//
// The arithmetic is that of the plain PyTorch versions in
// ops/pallas_train.py (psi_lap_train_plain and psi_lap_train_vjp_plain),
// which the CPU tests hold against the JAX package; the kernels' adjoints
// sum over units and points in their own order. The helpers here work on
// one point in one thread: K3 and the float32 K2 kernels run them so, with
// each point's H first-layer 4-stacks in registers. The float64 K2 kernels
// share the per-point geometry (Env, gz_adjoint) and run the MLP on tiles.
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

// Second-layer unit from its pre-activation stack (p0 with its bias).
template <typename T>
__device__ __forceinline__ Unit2<T> unit2_act(T p0, T p1, T p2, T p3, T c12) {
  Unit2<T> u;
  u.p0 = p0;
  u.p1 = p1;
  u.p2 = p2;
  u.p3 = p3;
  u.s = m_sigmoid(u.p0);
  u.e1 = u.s * (T(1) - u.s);
  u.e2 = u.e1 * (T(1) - T(2) * u.s);
  u.qq = u.p1 * u.p1 + u.p2 * u.p2 + T(2) * c12 * u.p1 * u.p2;
  u.bv = u.s;
  u.bl = u.e1 * u.p3 + u.e2 * u.qq;
  return u;
}

template <typename T, int H>
__device__ __forceinline__ Unit2<T> unit2(const T* W, int k, const Env<T>& e,
                                          const T (&a0)[H], const T (&a1)[H],
                                          const T (&a2)[H],
                                          const T (&a3)[H]) {
  using L = Layout<H>;
  T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T w = W[L::W2 + i * H + k];
    p0 += a0[i] * w;
    p1 += a1[i] * w;
    p2 += a2[i] * w;
    p3 += a3[i] * w;
  }
  return unit2_act(p0 + W[L::B2 + k], p1, p2, p3, e.c12);
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

// Cotangents of the GZ pair's terms for psi += v1 + P v2,
// lap += v1 s1 + P v2 s2.
template <typename T>
struct GZCot {
  GZ<T> g;
  T dv1, ds1, dv2, ds2;
};

template <typename T>
__device__ __forceinline__ GZCot<T> gz_cotangents(T a, T b, T psym,
                                                  const Env<T>& e, T dpsi,
                                                  T dlap) {
  GZCot<T> k;
  k.g = gz(a, b, e);
  k.dv1 = dpsi + dlap * k.g.s1;
  k.ds1 = dlap * k.g.v1;
  k.dv2 = psym * (dpsi + dlap * k.g.s2);
  k.ds2 = psym * dlap * k.g.v2;
  return k;
}

// Adjoint of psi += v1 + P v2, lap += v1 s1 + P v2 s2 in (a, b).
template <typename T>
__device__ __forceinline__ void gz_adjoint(T a, T b, T psym, const Env<T>& e,
                                           T dpsi, T dlap, T& da, T& db) {
  const GZCot<T> k = gz_cotangents(a, b, psym, e, dpsi, dlap);
  const GZ<T>& g = k.g;
  const T sa = T(2) * a + T(2) * b * e.c12;
  const T sb = T(2) * b + T(2) * a * e.c12;
  da += -e.r1 * g.v1 * k.dv1 + k.ds1 * (sa - T(2) * e.i1) -
        e.r2 * g.v2 * k.dv2 + k.ds2 * (sa - T(2) * e.i2);
  db += -e.r2 * g.v1 * k.dv1 + k.ds1 * (sb - T(2) * e.i2) -
        e.r1 * g.v2 * k.dv2 + k.ds2 * (sb - T(2) * e.i1);
}

// The same in the direct geometry (point gradients): adds the cotangents
// of r1, r2 and c12 (v1 = e^{-a r1 - b r2}, s1 = base - 2a/r1 - 2b/r2 with
// base's 2ab c12, and the swapped pair).
template <typename T>
__device__ __forceinline__ void gz_geometry_adjoint(T a, T b, T psym,
                                                    const Env<T>& e, T dpsi,
                                                    T dlap, T& dr1, T& dr2,
                                                    T& dc12) {
  const GZCot<T> k = gz_cotangents(a, b, psym, e, dpsi, dlap);
  const T di1 = T(-2) * (a * k.ds1 + b * k.ds2);
  const T di2 = T(-2) * (b * k.ds1 + a * k.ds2);
  dr1 += -a * k.g.v1 * k.dv1 - b * k.g.v2 * k.dv2 - di1 * e.i1 * e.i1;
  dr2 += -b * k.g.v1 * k.dv1 - a * k.g.v2 * k.dv2 - di2 * e.i2 * e.i2;
  dc12 += T(2) * a * b * (k.ds1 + k.ds2);
}

// Adjoint of second-layer unit u for cotangents (cv, cl) on its branch's
// (value, laplacian) and output weight owk: the cotangents g0..g3 of its
// pre-activation stack, its term cv bv + cl bl of the output weight's
// gradient, and (point gradients) its term of c12's cotangent, through qq.
template <typename T>
struct Grad2 {
  T g0, g1, g2, g3, dow, dc12;
};

template <typename T>
__device__ __forceinline__ Grad2<T> unit2_adjoint(const Unit2<T>& u, T c12,
                                                  T owk, T cv, T cl) {
  // bv = s(p0), bl = e1(p0) p3 + e2(p0) qq, qq = p1^2 + p2^2 + 2 c12 p1 p2
  const T dbv = cv * owk;
  const T dbl = cl * owk;
  const T e3 = u.e2 * (T(1) - T(2) * u.s) - T(2) * u.e1 * u.e1;
  const T dq = dbl * u.e2;
  Grad2<T> r;
  r.g0 = dbv * u.e1 + dbl * (u.e2 * u.p3 + e3 * u.qq);
  r.g1 = dq * (T(2) * u.p1 + T(2) * c12 * u.p2);
  r.g2 = dq * (T(2) * u.p2 + T(2) * c12 * u.p1);
  r.g3 = dbl * u.e1;
  r.dow = cv * u.bv + cl * u.bl;
  r.dc12 = dq * T(2) * u.p1 * u.p2;
  return r;
}

// Adjoint of a first-layer unit with input weights (w0, w1) and sigmoid
// value s, for cotangents (da0..da3) of its stack: the cotangents of its
// pre-activation z, gradient coefficients (ga, gb) and laplacian lz, and
// (point gradients) its term of c12's cotangent, through q. Nothing
// transcendental is evaluated again: d1, d2, d3 are polynomials in s.
template <typename T>
struct Grad1 {
  T dz, dga, dgb, dlz, dc12;
};

template <typename T>
__device__ __forceinline__ Grad1<T> unit1_adjoint(T s, T w0, T w1,
                                                  const Env<T>& e, T da0,
                                                  T da1, T da2, T da3) {
  const T d1 = s * (T(1) - s);
  const T d2 = d1 * (T(1) - T(2) * s);
  const T d3 = d2 * (T(1) - T(2) * s) - T(2) * d1 * d1;
  const T ga = e.g1 * w0;
  const T gb = e.g2 * w1;
  const T lz = e.l1 * w0 + e.l2 * w1;
  const T q = ga * ga + gb * gb + T(2) * e.c12 * ga * gb;
  Grad1<T> r;
  r.dz = da0 * d1 + (da1 * ga + da2 * gb + da3 * lz) * d2 + da3 * q * d3;
  r.dga = da1 * d1 + da3 * d2 * (T(2) * ga + T(2) * e.c12 * gb);
  r.dgb = da2 * d1 + da3 * d2 * (T(2) * gb + T(2) * e.c12 * ga);
  r.dlz = da3 * d1;
  r.dc12 = da3 * d2 * T(2) * ga * gb;
  return r;
}

// Derivatives in the exponent a of one branch's envelope stacks, so that a
// unit adds w0 (dz kf1 + dga kg1 + dlz kl1) + w1 (dz kf2 + dgb kg2 +
// dlz kl2) to the cotangent of a: f = e^{-a r}: df/da = -r f; g = -a f:
// dg/da = a r f - f; l = f (a^2 - 2a/r): dl/da = f (2a - 2/r) - r l.
template <typename T>
struct EnvDa {
  T kf1, kg1, kl1, kf2, kg2, kl2;
};

template <typename T>
__device__ __forceinline__ EnvDa<T> env_da(T a, const Env<T>& e) {
  EnvDa<T> k;
  k.kf1 = -e.r1 * e.f1;
  k.kg1 = a * e.r1 * e.f1 - e.f1;
  k.kl1 = e.f1 * (T(2) * a - T(2) * e.i1) - e.r1 * e.l1;
  k.kf2 = -e.r2 * e.f2;
  k.kg2 = a * e.r2 * e.f2 - e.f2;
  k.kl2 = e.f2 * (T(2) * a - T(2) * e.i2) - e.r2 * e.l2;
  return k;
}

// The unit's share of the cotangent of a.
template <typename T>
__device__ __forceinline__ T unit1_da(const Grad1<T>& d, T w0, T w1,
                                      const EnvDa<T>& k) {
  return w0 * (d.dz * k.kf1 + d.dga * k.kg1 + d.dlz * k.kl1) +
         w1 * (d.dz * k.kf2 + d.dgb * k.kg2 + d.dlz * k.kl2);
}

// Point gradients: the cotangents of a branch's envelope stacks (value f,
// gradient coefficient g, laplacian l of each envelope) and of its c12,
// summed over the units: a unit adds w0 (dz, dga, dlz) to envelope 1's,
// w1 (dz, dgb, dlz) to envelope 2's, and its Grad1 and Grad2 dc12 terms.
enum EnvCot { kCf1, kCg1, kCl1, kCf2, kCg2, kCl2, kCc12, kEnvCots };

template <typename T>
__device__ __forceinline__ void unit1_env_cot(const Grad1<T>& d, T w0, T w1,
                                              T (&c)[kEnvCots]) {
  c[kCf1] += d.dz * w0;
  c[kCg1] += d.dga * w0;
  c[kCl1] += d.dlz * w0;
  c[kCf2] += d.dz * w1;
  c[kCg2] += d.dgb * w1;
  c[kCl2] += d.dlz * w1;
  c[kCc12] += d.dc12;
}

// A branch's envelope cotangents carried to its r1, r2 and c12: per
// envelope f = e^{-a r}: df/dr = -a f; g = -a f: dg/dr = a^2 f;
// l = f (a^2 - 2a/r): dl/dr = -a l + 2a f / r^2 (the plain version is
// ops/pallas_train._envelope_vjp).
template <typename T>
__device__ __forceinline__ void env_adjoint(T a, const Env<T>& e,
                                            const T (&c)[kEnvCots], T& dr1,
                                            T& dr2, T& dc12) {
  dr1 += -a * e.f1 * c[kCf1] + a * a * e.f1 * c[kCg1] +
         (T(2) * a * e.f1 * e.i1 * e.i1 - a * e.l1) * c[kCl1];
  dr2 += -a * e.f2 * c[kCf2] + a * a * e.f2 * c[kCg2] +
         (T(2) * a * e.f2 * e.i2 * e.i2 - a * e.l2) * c[kCl2];
  dc12 += c[kCc12];
}

// One branch's envelope cotangents (and, for the direct branch, the GZ
// pair's geometry cotangents dr1, dr2, dc12 already in them) carried
// through its geometry to the point: adds to (dx, dy, dz, dR).
template <typename T>
__device__ __forceinline__ void branch_point_adjoint(
    T x, T y, T z, T R, T ry, T rz, T a, bool mirror, const Env<T>& e,
    const T (&c)[kEnvCots], T dr1, T dr2, T dc12, T& dx, T& dy, T& dz,
    T& dR) {
  env_adjoint(a, e, c, dr1, dr2, dc12);
  T tx, ty, tz, tr;
  kern::geometry_adjoint(mirror ? -x : x, y, z, R, ry, rz, e.i1, e.i2, e.c12,
                         dr1, dr2, dc12, tx, ty, tz, tr);
  dx += mirror ? -tx : tx;
  dy += ty;
  dz += tz;
  dR += tr;
}

}  // namespace trn

// C entry points return cudaGetLastError() of their launch; this names it.
extern "C" const char* train_error_string(int err);
