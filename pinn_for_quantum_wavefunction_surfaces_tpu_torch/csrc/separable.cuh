// Arithmetic and tile machinery shared by the separable (psi, lap psi)
// kernels.
//
// The arithmetic is the same, step for step, as the plain PyTorch versions
// in ops/pallas_separable.py (psi_lap_separable_plain and
// psi_lap_separable_vjp_plain), which the CPU tests hold against the JAX
// package. Every spatial gradient lies in span{u1, u2} (unit vectors from
// the nuclei), so gradients are kept as two coefficients and dot products
// reduce to scalars with u1.u2 = c12.
//
// Work layout. A block of kThreads threads owns a tile of P points at a
// time. The per-point scalar work (geometry, GZ pair, bounded correction,
// product rule and their adjoints) runs one thread a point on the block's
// first P threads, the scalar lanes; what the MLPs need of it, and what
// they return, passes through per-point vectors in shared memory. For the
// MLPs, TPP threads share a point, UPT consecutive units each.
// An MLP's first-layer triples are the [3P, H] tile A in shared memory
// (row c P + p holds component c of point p), and the H x H products
//   L = A W2,  dA = G W2^T,  dW2 += A^T G
// run on the tile: on the float64 tensor cores (mma.sync m8n8k4 through
// nvcuda::wmma fragments of double) where T is double and 8 divides H, as
// FMAs from shared memory otherwise (float32 keeps full float32: TF32 would
// break its tolerances).
//
// Weight layout of one MLP (2 -> H -> H -> 1, tanh), packed row-major as the
// wrapper concatenates them: w1 (2,H) | b1 (H) | w2 (H,H) | b2 (H) | ow (H)
// | ob (1); the lambda MLP first, then the mu MLP. In shared memory each MLP
// starts on a 32-byte boundary (stride WSP), as the fragments' loads need.
#pragma once

#include <mma.h>

#include <type_traits>

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

// Phi_GZ = fa + fb, fb = P e^{-a r2 - b r1}: value, gradient coefficients
// (p1, p2) on (u1, u2), laplacian.
template <typename T>
struct GZ {
  T fa, fb, sa, sb, phi0, p1, p2, phil;
};

// ---------------------------------------------------------------------------
// Tiles

constexpr int kThreads = 256;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int H>
struct Tile {
  static constexpr int TPP = H < 8 ? H : 8;        // threads a point
  static constexpr int UPT = H / TPP;              // units a thread
  static constexpr int P = kThreads / TPP;         // points a tile
  static constexpr int ROWS = 3 * P;               // rows of a [3P, H] tile
  static constexpr int WSP = (Layout<H>::SIZE + 3) & ~3;  // padded MLP
  static_assert(P % 32 == 0, "the scalar lanes are whole warps");
};

// Per-point vectors of a tile in shared memory, [slot][P]: the MLP inputs,
// the MLP output triples, and (K1-bwd) their cotangents; in K1-bwd's
// point-gradient instantiation also each MLP's input cotangents (s: t or
// eta^2, and cf = R/4).
enum Slot { kT0, kE0, kCf, kL0, kL1, kL2, kM0, kM1, kM2, kDq0, kDl1, kDl2,
            kDm1, kDm2, kDsL, kDsM, kDcfL, kDcfM, kFwdSlots = kDq0,
            kBwdSlots = kDm2 + 1, kPgSlots = kDcfM + 1 };

// The calling thread's first unit: it owns units unit0 .. unit0 + UPT - 1
// of its point.
template <int H>
__device__ __forceinline__ int unit0() {
  return (threadIdx.x % Tile<H>::TPP) * Tile<H>::UPT;
}

// The H x H products on the float64 tensor cores?
template <typename T, int H>
__host__ __device__ constexpr bool use_mma() {
  return std::is_same<T, double>::value && H % 8 == 0;
}

// C = A W2 (TRANS false) or C = A W2^T (TRANS true); A and C are [3P, H]
// tiles, W2 is [H, H]; all row-major in shared memory. The caller
// synchronises before (A complete) and after (C complete).
template <typename T, int H, bool TRANS>
__device__ __forceinline__ void tile_product(const T* A, const T* W2, T* C) {
  using TL = Tile<H>;
  if constexpr (use_mma<T, H>()) {
    using namespace nvcuda;
    constexpr int CT = H / 8;
    constexpr int NT = (TL::ROWS / 8) * CT;
    const int warp = threadIdx.x / 32;
    for (int tt = warp; tt < NT; tt += kWarps) {
      const int r0 = (tt / CT) * 8, c0 = (tt % CT) * 8;
      wmma::fragment<wmma::accumulator, 8, 8, 4, double> acc;
      wmma::fill_fragment(acc, 0.0);
#pragma unroll
      for (int k0 = 0; k0 < H; k0 += 4) {
        wmma::fragment<wmma::matrix_a, 8, 8, 4, double, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + r0 * H + k0, H);
        if constexpr (TRANS) {  // B[k][n] = W2[n][k]: W2 read column-major
          wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::col_major> b;
          wmma::load_matrix_sync(b, W2 + c0 * H + k0, H);
          wmma::mma_sync(acc, a, b, acc);
        } else {
          wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::row_major> b;
          wmma::load_matrix_sync(b, W2 + k0 * H + c0, H);
          wmma::mma_sync(acc, a, b, acc);
        }
      }
      wmma::store_matrix_sync(C + r0 * H + c0, acc, H, wmma::mem_row_major);
    }
  } else {
    // each thread: its point's three rows at its own units, j outermost so
    // that each loaded value serves 3 or UPT multiply-adds
    const int p = threadIdx.x / TL::TPP, k0 = unit0<H>();
    T acc[3][TL::UPT];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i) acc[c][i] = T(0);
#pragma unroll
    for (int j = 0; j < H; ++j) {
      T wv[TL::UPT];
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i)
        wv[i] = TRANS ? W2[(k0 + i) * H + j] : W2[j * H + k0 + i];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T av = A[(c * TL::P + p) * H + j];
#pragma unroll
        for (int i = 0; i < TL::UPT; ++i) acc[c][i] += av * wv[i];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i)
        C[(c * TL::P + p) * H + k0 + i] = acc[c][i];
  }
}

// Geometry and GZ pair of one point: the plain versions' _geometry,
// _features and _gz.
template <typename T>
__device__ __forceinline__ void point_gz(T x, T y, T z, T r, T ry, T rz, T a,
                                         T b, T psym, Point<T>& p, GZ<T>& g) {
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
  g.fa = m_exp(-a * p.r1 - b * p.r2);
  g.fb = psym * m_exp(-a * p.r2 - b * p.r1);
  const T s = a * a + b * b + T(2) * a * b * p.c12;
  g.sa = s - T(2) * a * p.i1 - T(2) * b * p.i2;
  g.sb = s - T(2) * a * p.i2 - T(2) * b * p.i1;
  g.phi0 = g.fa + g.fb;
  g.p1 = -(a * g.fa + b * g.fb);
  g.p2 = -(b * g.fa + a * g.fb);
  g.phil = g.fa * g.sa + g.fb * g.sb;
}

// Sum of v over the TPP lanes of a point (a butterfly: every lane ends with
// the same bits, and the order is fixed).
template <int H, typename T>
__device__ __forceinline__ T point_sum(T v) {
#pragma unroll
  for (int off = 1; off < Tile<H>::TPP; off <<= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum of v over the points of a warp, lane by lane of a point.
template <int H, typename T>
__device__ __forceinline__ T warp_points_sum(T v) {
#pragma unroll
  for (int off = Tile<H>::TPP; off < 32; off <<= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One MLP on the tile: the output triple (o0, o1, o2) = (f, df/ds, d2f/ds2)
// of the calling thread's point (every lane of the point gets it). W: this
// MLP's weights. X receives the first-layer triples a_j = (t, g w, h w^2)
// of the seed (s, 1, 0); Y the second layer's (u, l1, l2), u = tanh(l0)
// written over l0 by the element's own thread: what the adjoint needs.
// After its last barrier (the one after the product) X is no longer read,
// and each thread reads and writes only its own elements of Y.
template <typename T, int H>
__device__ __forceinline__ void mlp_tile_forward(const T* W, T s, T cf, T* X,
                                                 T* Y, T& o0, T& o1, T& o2) {
  using L = Layout<H>;
  using TL = Tile<H>;
  const int p = threadIdx.x / TL::TPP, u0 = unit0<H>();
#pragma unroll
  for (int i = 0; i < TL::UPT; ++i) {
    const int j = u0 + i;
    const T w = W[L::W1 + j];
    const T t = m_tanh(s * w + cf * W[L::W1 + H + j] + W[L::B1 + j]);
    const T g = T(1) - t * t;
    const T h = T(-2) * t * g;
    X[p * H + j] = t;
    X[(TL::P + p) * H + j] = g * w;
    X[(2 * TL::P + p) * H + j] = h * w * w;
  }
  __syncthreads();
  tile_product<T, H, false>(X, W + L::W2, Y);
  __syncthreads();
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int i = 0; i < TL::UPT; ++i) {
    const int k = u0 + i;
    const T u = m_tanh(Y[p * H + k] + W[L::B2 + k]);
    const T l1 = Y[(TL::P + p) * H + k];
    const T l2 = Y[(2 * TL::P + p) * H + k];
    const T gg = T(1) - u * u;
    const T hh = T(-2) * u * gg;
    const T owk = W[L::OW + k];
    Y[p * H + k] = u;
    acc0 += u * owk;
    acc1 += gg * l1 * owk;
    acc2 += (gg * l2 + hh * l1 * l1) * owk;
  }
  o0 = point_sum<H>(acc0) + W[L::OB];
  o1 = point_sum<H>(acc1);
  o2 = point_sum<H>(acc2);
}

// Load both MLPs' packed weights into shared memory at stride WSP.
template <typename T, int H>
__device__ __forceinline__ void load_weights(const T* __restrict__ w, T* sw) {
  constexpr int WS = Layout<H>::SIZE;
  for (int i = threadIdx.x; i < 2 * WS; i += kThreads)
    sw[(i / WS) * Tile<H>::WSP + i % WS] = w[i];
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

// The cotangents inside the adjoint of top_forward for (dpsi, dlap), which
// both top_adjoint and point_adjoint read: q0 (shared by lam0 and mu0), qq,
// ql, xv, phil, gpt, gpe, and the GZ pair's two terms fa, fb.
template <typename T>
struct TopCot {
  T dq0, dqq, dql, dxv, dphil, dgpt, dgpe, dfa, dfb;
};

template <typename T>
__device__ __forceinline__ TopCot<T> top_cotangents(T a, T b, T l1, T m1,
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
  TopCot<T> k;
  k.dq0 = dth * s.d1 / c;
  k.dqq = dqq;
  k.dql = dql;
  k.dxv = dxv;
  k.dphil = dphil;
  k.dgpt = dxv * l1;
  k.dgpe = dxv * m1;
  const T dp1 = k.dgpt * p.kt + k.dgpe * p.ke;
  const T dp2 = k.dgpt * p.kt - k.dgpe * p.ke;
  k.dfa = dphi0 - dp1 * a - dp2 * b + dphil * g.sa;
  k.dfb = dphi0 - dp1 * b - dp2 * a + dphil * g.sb;
  return k;
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
  const TopCot<T> k = top_cotangents(a, b, l1, m1, dpsi, dlap, g, p, s);
  TopGrad<T> r;
  r.dq0 = k.dq0;
  r.dl1 = k.dxv * s.gpt + k.dql * p.tl + k.dqq * T(2) * l1 * p.gtt;
  r.dm1 = k.dxv * s.gpe + k.dql * p.el2 + k.dqq * T(2) * m1 * p.gee;
  r.dl2 = k.dql * p.gtt;
  r.dm2 = k.dql * p.gee;
  const T dp1 = k.dgpt * p.kt + k.dgpe * p.ke;
  const T dp2 = k.dgpt * p.kt - k.dgpe * p.ke;
  const T s_a = T(2) * (a + b * p.c12);
  const T s_b = T(2) * (b + a * p.c12);
  r.da = (-dp1 * g.fa - dp2 * g.fb +
          k.dphil * (g.fa * (s_a - T(2) * p.i1) + g.fb * (s_a - T(2) * p.i2)) -
          p.r1 * g.fa * k.dfa - p.r2 * g.fb * k.dfb);
  r.db = (-dp1 * g.fb - dp2 * g.fa +
          k.dphil * (g.fa * (s_b - T(2) * p.i2) + g.fb * (s_b - T(2) * p.i1)) -
          p.r2 * g.fa * k.dfa - p.r1 * g.fb * k.dfb);
  return r;
}

// The point gradient (dx, dy, dz, dR) of one point for cotangents (dpsi,
// dlap), given its MLP output triples and the MLPs' input cotangents ds_l
// (of t), ds_m (of eta^2) and dcf (of R/4, both MLPs): the adjoint of the
// top's features (tl, gtt, el2, gee, kt, ke), of the MLP inputs t and
// eta^2, of the GZ pair and of the explicit R in t, eta and cf, then the
// geometry's. The point's geometry, GZ pair and top are evaluated again
// from its inputs (the same arithmetic as the forward, so the same bits).
// The plain version is the point_grads branch of
// ops/pallas_separable.psi_lap_separable_vjp_plain.
template <typename T>
__device__ __forceinline__ void point_adjoint(
    T x, T y, T z, T R, T ry, T rz, T a, T b, T psym, T l0, T l1, T l2, T m0,
    T m1, T m2, T dpsi, T dlap, T ds_l, T ds_m, T dcf, T& dx, T& dy, T& dz,
    T& dR) {
  Point<T> p;
  GZ<T> g;
  point_gz(x, y, z, R, ry, rz, a, b, psym, p, g);
  Top<T> s;
  top_forward(l0, l1, l2, m0, m1, m2, g, p, s);
  const TopCot<T> k = top_cotangents(a, b, l1, m1, dpsi, dlap, g, p, s);
  // the top's features
  const T dtl = k.dql * l1;
  const T dgtt = k.dqq * l1 * l1 + k.dql * l2;
  const T del2 = k.dql * m1;
  const T dgee = k.dqq * m1 * m1 + k.dql * m2;
  const T dkt = k.dgpt * (g.p1 + g.p2);
  const T dke = k.dgpe * (g.p1 - g.p2);
  // the GZ pair in the geometry (fa, fb, and sa, sb through phil)
  const T dsa = k.dphil * g.fa, dsb = k.dphil * g.fb;
  T dr1 = -(a * g.fa * k.dfa + b * g.fb * k.dfb);
  T dr2 = -(b * g.fa * k.dfa + a * g.fb * k.dfb);
  T dc12 = T(2) * a * b * (dsa + dsb);
  T di1 = T(-2) * (a * dsa + b * dsb);
  T di2 = T(-2) * (b * dsa + a * dsb);
  // t = e^{R - (r1+r2)/2} with tl, gtt, kt
  const T hc = T(1) + p.c12;
  const T dt0 = ds_l + dtl * (T(0.5) * hc - (p.i1 + p.i2)) +
                dgtt * p.t0 * hc - T(0.5) * dkt * hc;
  dc12 += T(0.5) * p.t0 * (dtl + dgtt * p.t0 - dkt);
  di1 -= dtl * p.t0;
  di2 -= dtl * p.t0;
  const T dex = dt0 * p.t0;
  T dr = dex + T(0.25) * dcf;
  dr1 -= T(0.5) * dex;
  dr2 -= T(0.5) * dex;
  // ev = (r1 - r2)/(2R), eta^2 = ev^2, el2, gee, ke
  const T inv_r = T(1) / R;
  const T ev = (p.r1 - p.r2) * (T(0.5) * inv_r);
  const T mc = T(1) - p.c12;
  const T de0 = ds_m + dgee * T(2) * mc * inv_r * inv_r;
  const T dev = T(2) * ev * de0 + del2 * T(2) * (p.i1 - p.i2) * inv_r +
                dke * inv_r * mc;
  di1 += del2 * T(2) * ev * inv_r;
  di2 -= del2 * T(2) * ev * inv_r;
  dc12 -= (del2 + T(2) * p.e0 * dgee) * inv_r * inv_r + dke * ev * inv_r;
  const T dinv = del2 * (T(2) * ev * (p.i1 - p.i2) + T(2) * mc * inv_r) +
                 dgee * T(4) * p.e0 * mc * inv_r + dke * ev * mc +
                 dev * T(0.5) * (p.r1 - p.r2);
  dr1 += T(0.5) * dev * inv_r - di1 * p.i1 * p.i1;
  dr2 -= T(0.5) * dev * inv_r + di2 * p.i2 * p.i2;
  dr -= dinv * inv_r * inv_r;
  T dRg;
  kern::geometry_adjoint(x, y, z, R, ry, rz, p.i1, p.i2, p.c12, dr1, dr2,
                         dc12, dx, dy, dz, dRg);
  dR = dr + dRg;
}

}  // namespace sep

// C entry points return cudaGetLastError() of their launch; this names it.
extern "C" const char* separable_error_string(int err);
