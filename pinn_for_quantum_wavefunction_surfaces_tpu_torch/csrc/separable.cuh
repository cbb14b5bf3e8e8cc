// Per-point arithmetic shared by the separable (psi, lap psi) kernels.
//
// One CUDA thread evaluates one point. The arithmetic is the same, step for
// step, as the plain PyTorch versions in ops/pallas_separable.py
// (psi_lap_separable_plain and psi_lap_separable_vjp_plain), which the CPU
// tests hold against the JAX package. Every spatial gradient lies in
// span{u1, u2} (unit vectors from the nuclei), so gradients are kept as two
// coefficients and dot products reduce to scalars with u1.u2 = c12.
//
// Weight layout of one MLP (2 -> H -> H -> 1, tanh), packed row-major as the
// wrapper concatenates them: w1 (2,H) | b1 (H) | w2 (H,H) | b2 (H) | ow (H)
// | ob (1); the lambda MLP first, then the mu MLP.
#pragma once

#include "common.cuh"

namespace sep {

using kern::Layout;
using kern::m_exp;
using kern::m_sqrt;
using kern::m_tanh;

// LOG_CORR_CAP: the log-correction is c tanh((lam + mu) / c)
template <typename T>
__device__ __forceinline__ T cap() { return T(3); }

// Geometry and the MLP input features of one point.
template <typename T>
struct Point {
  T r1, r2, i1, i2, c12;         // radii, inverse radii, u1.u2
  T t0, tl, gtt;                 // t = e^{R-(r1+r2)/2}, lap t, |grad t|^2
  T e0, el2, gee;                // eta^2, lap eta^2, |grad eta^2|^2
  T kt, ke;                      // <g, grad t> = kt (g1+g2); eta^2: ke (g1-g2)
  T cf;                          // the constant MLP input R/4
};

template <typename T>
__device__ __forceinline__ void point_setup(T x, T y, T z, T r, T ry, T rz,
                                            Point<T>& p) {
  const T d1x = x - r, d1y = y - ry, d1z = z - rz;
  const T d2x = x + r, d2y = y + ry, d2z = z + rz;
  p.r1 = m_sqrt(d1x * d1x + d1y * d1y + d1z * d1z);
  p.r2 = m_sqrt(d2x * d2x + d2y * d2y + d2z * d2z);
  p.i1 = T(1) / p.r1;
  p.i2 = T(1) / p.r2;
  p.c12 = (d1x * d2x + d1y * d2y + d1z * d2z) * p.i1 * p.i2;
  p.t0 = m_exp(r - T(0.5) * (p.r1 + p.r2));
  p.tl = p.t0 * (T(0.5) * (T(1) + p.c12) - (p.i1 + p.i2));
  p.gtt = T(0.5) * p.t0 * p.t0 * (T(1) + p.c12);
  const T inv_r = T(1) / r;
  const T ev = (p.r1 - p.r2) * (T(0.5) * inv_r);
  p.e0 = ev * ev;
  p.el2 = T(2) * ev * (p.i1 - p.i2) * inv_r + (T(1) - p.c12) * inv_r * inv_r;
  p.gee = T(2) * p.e0 * (T(1) - p.c12) * inv_r * inv_r;
  p.kt = T(-0.5) * p.t0 * (T(1) + p.c12);
  p.ke = ev * inv_r * (T(1) - p.c12);
  p.cf = T(0.25) * r;
}

// Phi_GZ = fa + fb, fb = P e^{-a r2 - b r1}: value, gradient coefficients
// (p1, p2) on (u1, u2), laplacian.
template <typename T>
struct GZ {
  T fa, fb, sa, sb, phi0, p1, p2, phil;
};

template <typename T>
__device__ __forceinline__ GZ<T> gz(T a, T b, T psym, const Point<T>& p) {
  GZ<T> g;
  g.fa = m_exp(-a * p.r1 - b * p.r2);
  g.fb = psym * m_exp(-a * p.r2 - b * p.r1);
  const T s = a * a + b * b + T(2) * a * b * p.c12;
  g.sa = s - T(2) * a * p.i1 - T(2) * b * p.i2;
  g.sb = s - T(2) * a * p.i2 - T(2) * b * p.i1;
  g.phi0 = g.fa + g.fb;
  g.p1 = -(a * g.fa + b * g.fb);
  g.p2 = -(b * g.fa + a * g.fb);
  g.phil = g.fa * g.sa + g.fb * g.sb;
  return g;
}

// First layer on the seed triple (s, 1, 0): a1_j = (T, g w, h w^2).
template <typename T, int H>
__device__ __forceinline__ void mlp_first(const T* W, T s, T cf, T (&a0)[H],
                                          T (&a1)[H], T (&a2)[H]) {
  using L = Layout<H>;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T w = W[L::W1 + j];
    const T zz = s * w + cf * W[L::W1 + H + j] + W[L::B1 + j];
    const T t = m_tanh(zz);
    const T g = T(1) - t * t;
    const T h = T(-2) * t * g;
    a0[j] = t;
    a1[j] = g * w;
    a2[j] = h * w * w;
  }
}

// Second-layer pre-activation triple of neuron k.
template <typename T, int H>
__device__ __forceinline__ void mlp_lin(const T* W, int k, const T (&a0)[H],
                                        const T (&a1)[H], const T (&a2)[H],
                                        T& l0, T& l1, T& l2) {
  using L = Layout<H>;
  l0 = T(0);
  l1 = T(0);
  l2 = T(0);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T wik = W[L::W2 + i * H + k];
    l0 += a0[i] * wik;
    l1 += a1[i] * wik;
    l2 += a2[i] * wik;
  }
  l0 += W[L::B2 + k];
}

// The whole MLP: output triple (o0, o1, o2) = (f, df/ds, d2f/ds2).
template <typename T, int H>
__device__ __forceinline__ void mlp_fwd(const T* W, T s, T cf, T& o0, T& o1,
                                        T& o2) {
  using L = Layout<H>;
  T a0[H], a1[H], a2[H];
  mlp_first<T, H>(W, s, cf, a0, a1, a2);
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    T l0, l1, l2;
    mlp_lin<T, H>(W, k, a0, a1, a2, l0, l1, l2);
    const T u = m_tanh(l0);
    const T gg = T(1) - u * u;
    const T hh = T(-2) * u * gg;
    const T owk = W[L::OW + k];
    acc0 += u * owk;
    acc1 += gg * l1 * owk;
    acc2 += (gg * l2 + hh * l1 * l1) * owk;
  }
  o0 = acc0 + W[L::OB];
  o1 = acc1;
  o2 = acc2;
}

// Bounded correction exp(c tanh((lam + mu) / c)) and the product rule.
template <typename T>
struct Top {
  T qq, ql, th, d1, d2, bl, wv, gpt, gpe, xv, e, kk, psi, lap;
};

template <typename T>
__device__ __forceinline__ void top_forward(T l0, T l1, T l2, T m0, T m1,
                                            T m2, const GZ<T>& g,
                                            const Point<T>& p, Top<T>& s) {
  const T c = cap<T>();
  const T q0 = l0 + m0;
  s.qq = l1 * l1 * p.gtt + m1 * m1 * p.gee;
  s.ql = l1 * p.tl + l2 * p.gtt + m1 * p.el2 + m2 * p.gee;
  s.th = m_tanh(q0 / c);
  s.d1 = T(1) - s.th * s.th;
  s.d2 = T(-2) * s.th * s.d1;
  s.bl = s.d1 * s.ql + s.d2 * s.qq / c;
  s.wv = s.bl + s.d1 * s.d1 * s.qq;
  s.gpt = p.kt * (g.p1 + g.p2);
  s.gpe = p.ke * (g.p1 - g.p2);
  s.xv = l1 * s.gpt + m1 * s.gpe;
  s.e = m_exp(c * s.th);
  s.kk = g.phil + g.phi0 * s.wv + T(2) * s.d1 * s.xv;
  s.psi = g.phi0 * s.e;
  s.lap = s.e * s.kk;
}

// Adjoint of top_forward and gz for cotangents (dpsi, dlap): the
// cotangents of both MLP output triples (dq0 is shared by lam0 and mu0)
// and of the GZ exponents a, b.
template <typename T>
struct TopGrad {
  T dq0, dl1, dl2, dm1, dm2, da, db;
};

template <typename T>
__device__ __forceinline__ TopGrad<T> top_adjoint(T a, T b, T l1, T m1,
                                                  T dpsi, T dlap,
                                                  const GZ<T>& g,
                                                  const Point<T>& p,
                                                  const Top<T>& s) {
  const T c = cap<T>();
  const T de = dpsi * g.phi0 + dlap * s.kk;
  const T dkk = dlap * s.e;
  const T dphi0 = dpsi * s.e + dkk * s.wv;
  const T dphil = dkk;
  const T dwv = dkk * g.phi0;
  T dd1 = dkk * T(2) * s.xv;
  const T dxv = dkk * T(2) * s.d1;
  const T dbl = dwv;
  dd1 = dd1 + dwv * T(2) * s.d1 * s.qq;
  T dqq = dwv * s.d1 * s.d1;
  dd1 = dd1 + dbl * s.ql;
  const T dql = dbl * s.d1;
  const T dd2 = dbl * s.qq / c;
  dqq = dqq + dbl * s.d2 / c;
  T dth = de * s.e * c;
  dth = dth - T(2) * s.d1 * dd2;
  dd1 = dd1 - T(2) * s.th * dd2;
  dth = dth - T(2) * s.th * dd1;
  TopGrad<T> r;
  r.dq0 = dth * s.d1 / c;
  r.dl1 = dxv * s.gpt + dql * p.tl + dqq * T(2) * l1 * p.gtt;
  r.dm1 = dxv * s.gpe + dql * p.el2 + dqq * T(2) * m1 * p.gee;
  r.dl2 = dql * p.gtt;
  r.dm2 = dql * p.gee;
  const T dgpt = dxv * l1;
  const T dgpe = dxv * m1;
  const T dp1 = dgpt * p.kt + dgpe * p.ke;
  const T dp2 = dgpt * p.kt - dgpe * p.ke;
  const T dfa = dphi0 - dp1 * a - dp2 * b + dphil * g.sa;
  const T dfb = dphi0 - dp1 * b - dp2 * a + dphil * g.sb;
  const T s_a = T(2) * (a + b * p.c12);
  const T s_b = T(2) * (b + a * p.c12);
  r.da = (-dp1 * g.fa - dp2 * g.fb +
          dphil * (g.fa * (s_a - T(2) * p.i1) + g.fb * (s_a - T(2) * p.i2)) -
          p.r1 * g.fa * dfa - p.r2 * g.fb * dfb);
  r.db = (-dp1 * g.fb - dp2 * g.fa +
          dphil * (g.fa * (s_b - T(2) * p.i2) + g.fb * (s_b - T(2) * p.i1)) -
          p.r2 * g.fa * dfa - p.r1 * g.fb * dfb);
  return r;
}

}  // namespace sep

// C entry points return cudaGetLastError() of their launch; this names it.
extern "C" const char* separable_error_string(int err);
