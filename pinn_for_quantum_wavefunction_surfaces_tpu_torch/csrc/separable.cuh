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
// Work layout, by type.
// - float64 (the tile kernels): a block of kThreads threads owns a tile of
//   P points at a time. The per-point scalar work (geometry, GZ pair,
//   bounded correction, product rule and their adjoints) runs one thread a
//   point on the block's first P threads, the scalar lanes; what the MLPs
//   need of it, and what they return, passes through per-point vectors in
//   shared memory. For the MLPs, TPP threads share a point, UPT consecutive
//   units each. An MLP's first-layer triples are the [3P, H] tile A in
//   shared memory (row c P + p holds component c of point p), and the
//   H x H products
//     L = A W2,  dA = G W2^T,  dW2 += A^T G
//   run on the tile: on the float64 tensor cores (mma.sync m8n8k4 through
//   nvcuda::wmma fragments of double) where 8 divides H, as FMAs from
//   shared memory at H = 4.
// - float32, and bfloat16 computing in float (the point kernels): one
//   thread a point from its inputs to its outputs, kPointThreads points a
//   block. Both MLPs' weights are staged once a block in shared memory,
//   each MLP's w2 rows 16-byte aligned; every thread of a warp reads the
//   same weights, so each read is a broadcast. A point's first-layer
//   triples stay in registers, and the second layer takes four units at a
//   time: one 16-byte read of w2[j][k..k+3] serves the point's three
//   components, 12 multiply-adds (mlp_point_forward). Threads meet at a
//   barrier only after the weights are staged, and in the backward around
//   its weight-gradient sums over the block's points. TF32 is not used (it
//   would break float32's tolerances).
//
// Weight layout of one MLP (2 -> H -> H -> 1, tanh), packed row-major as the
// wrapper concatenates them: w1 (2,H) | b1 (H) | w2 (H,H) | b2 (H) | ow (H)
// | ob (1); the lambda MLP first, then the mu MLP. In shared memory each MLP
// starts on a 32-byte boundary (stride WSP), as the fragments' loads need;
// with H a multiple of 4, w2, b2 and ow then start on 16-byte boundaries.
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
using kern::kFull;

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

// Load both MLPs' packed weights (storage type S) into shared memory at
// stride WSP, in the compute type T, by a block of NT threads.
template <typename T, int H, int NT = kThreads, typename S>
__device__ __forceinline__ void load_weights(const S* __restrict__ w, T* sw) {
  constexpr int WS = Layout<H>::SIZE;
  for (int i = threadIdx.x; i < 2 * WS; i += NT)
    sw[(i / WS) * Tile<H>::WSP + i % WS] = kern::ld(w[i]);
}

// ---------------------------------------------------------------------------
// The point kernels (float32; bfloat16 in float)

constexpr int kPointThreads = 128;  // points (threads) a block

// The float64 build runs on tiles, the float32 and bfloat16 builds (storage
// type S) one thread a point.
template <typename S>
constexpr bool tiled() {
  return std::is_same<S, double>::value;
}

// Points a block takes at a time (the wrappers' points_per_tile).
template <typename S, int H>
constexpr int points_per_tile() {
  return tiled<S>() ? Tile<H>::P : kPointThreads;
}

// v, hidden from the compiler: what is computed from it is computed anew,
// never shared with the same expression of the original value (sharing
// would change which products are fused into multiply-adds, and so the
// bits, of the code that the expression came from).
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// One MLP at the calling thread's point: the output triple (o0, o1, o2) =
// (f, df/ds, d2f/ds2) for the seed (s, 1, 0) and the constant input cf.
// The first-layer triples a_j = (t, g w, h w^2) stay in registers; the
// second layer runs four units at a time in a loop unrolled twice (fully
// unrolled, the compiler loads many units' weights ahead and spills 2.7 KB
// at H = 16). ROWS (the backward): the units' t go to the point's row A
// (the weight gradient forms the triples again from t) and the second
// layer's (u, l1, l2) to its row Y (component c at c H), and the loop
// stays rolled (it runs beside the backward's registers).
template <int H, bool ROWS>
__device__ __forceinline__ void mlp_point_forward(const float* W, float s,
                                                  float cf, float* A,
                                                  float* Y, float& o0,
                                                  float& o1, float& o2) {
  using L = Layout<H>;
  float x0[H], x1[H], x2[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float w = W[L::W1 + j];
    const float t = m_tanh(s * w + cf * W[L::W1 + H + j] + W[L::B1 + j]);
    const float g = 1.0f - t * t;
    const float h = -2.0f * t * g;
    x0[j] = t;
    x1[j] = g * w;
    x2[j] = h * w * w;
  }
  if constexpr (ROWS) {
#pragma unroll
    for (int j = 0; j < H; j += 4) kern::store4(A + j, x0 + j);
  }
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
#pragma unroll (ROWS ? 1 : 2)
  for (int k0 = 0; k0 < H; k0 += 4) {
    float y[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[c][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float w[4];
      kern::load4(W + L::W2 + j * H + k0, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[0][i] += x0[j] * w[i];
        y[1][i] += x1[j] * w[i];
        y[2][i] += x2[j] * w[i];
      }
    }
    float b2[4], ow[4];
    kern::load4(W + L::B2 + k0, b2);
    kern::load4(W + L::OW + k0, ow);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float u = m_tanh(y[0][i] + b2[i]);
      const float l1 = y[1][i], l2 = y[2][i];
      const float gg = 1.0f - u * u;
      const float hh = -2.0f * u * gg;
      y[0][i] = u;
      acc0 += u * ow[i];
      acc1 += gg * l1 * ow[i];
      acc2 += (gg * l2 + hh * l1 * l1) * ow[i];
    }
    if constexpr (ROWS) {
#pragma unroll
      for (int c = 0; c < 3; ++c) kern::store4(Y + c * H + k0, y[c]);
    }
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

// ---------------------------------------------------------------------------
// The excited-state factor epilogue (the kernels' EX = true instantiations)
//
// psi = psi_B F with F = Q(p) A(eta^2) h(y, z): Q = (p - c1)(p - c2) over
// the radial nodes (none, one or two), p = (r1 + r2)/2; A = eta^2 - n0 (the
// angular node, or 1); h = Re[(y + i z)^m] (m = m_abs, or 1). c1, c2 and n0
// are per-point inputs (row heads broadcast to the points). Then
//   lap psi = F lap psi_B + 2 grad psi_B . grad F + psi_B lap F.
// psi_B and F_s = Q A depend on the point through r1 and r2 alone, so a
// gradient is kept as its coefficients (gs, gd) = (d/dr1 + d/dr2, d/dr1 -
// d/dr2) on (u1 + u2)/2 and (u1 - u2)/2:
//   f . g = (fs gs (1 + c12) + fd gd (1 - c12)) / 2,
//   f . grad h = (fs ws + fd wd) / 2,  ws, wd = u1 . grad h +- u2 . grad h;
// grad p . grad eta^2 = 0 (confocal coordinates) and lap h = 0. The plain
// version is _factor_fwd, _factor_vjp and _grad_psi_b_vjp in
// ops/pallas_separable.py, transliterated here.

// The factors of a launch, from the wrappers' code radial | angular << 2 |
// m << 3 (ops/pallas_separable.factor_code): the same for every point.
struct Factors {
  int rad, ang, m;
};

__device__ __forceinline__ Factors factors_of(int code) {
  return Factors{code & 3, (code >> 2) & 1, code >> 3};
}

// The epilogue's values of one point: what its adjoint reads, then psi and
// lap psi.
template <typename T>
struct Ex {
  T he, sp, hc, mc;         // d eta^2/d r1, lap p, 1 + c12, 1 - c12
  T n1, n2, q, q1, lq, aa;  // p - c1, p - c2, Q, dQ/dp, lap Q, A
  T fsv, fs, fd, lfs;       // F_s, its coefficients (fs, fd), lap F_s
  T h, ws, wd;              // h and its (ws, wd)
  T bs, bd, gs, gd;         // grad psi_B = e (bs, bd) = (gs, gd)
  T xh, lf, f, psi, lap;    // grad psi_B . grad h, lap F, F, the outputs
};

template <typename T>
__device__ __forceinline__ void ex_forward(Factors fc, T y, T z, T R, T ry,
                                           T rz, T c1, T c2, T n0, T l1,
                                           T m1, const GZ<T>& g,
                                           const Point<T>& p,
                                           const Top<T>& s, Ex<T>& x) {
  x.hc = T(1) + p.c12;
  x.mc = T(1) - p.c12;
  const T inv_r = T(1) / R;
  x.he = (p.r1 - p.r2) * (T(0.5) * inv_r) * inv_r;
  x.sp = p.i1 + p.i2;
  const T ph = T(0.5) * (p.r1 + p.r2);
  x.n1 = ph - c1;
  x.n2 = ph - c2;
  if (fc.rad == 0) {
    x.q = T(1);
    x.q1 = T(0);
    x.lq = T(0);
  } else if (fc.rad == 1) {
    x.q = x.n1;
    x.q1 = T(1);
    x.lq = x.sp;
  } else {
    x.q = x.n1 * x.n2;
    x.q1 = x.n1 + x.n2;
    x.lq = x.hc + x.q1 * x.sp;  // Q'' |grad p|^2 + Q' lap p
  }
  if (fc.ang) {
    x.aa = p.e0 - n0;
    x.fsv = x.q * x.aa;
    x.fs = x.aa * x.q1;
    x.fd = T(2) * x.q * x.he;
    x.lfs = x.aa * x.lq + x.q * p.el2;
  } else {
    x.aa = T(1);
    x.fsv = x.q;
    x.fs = x.q1;
    x.fd = T(0);
    x.lfs = x.lq;
  }
  if (fc.m) {
    // Re, Im of (y + i z)^m; grad Re w^m = m (Re w^{m-1}, -Im w^{m-1})
    T re = y, im = z;
    for (int k = 1; k < fc.m; ++k) {
      const T t = re * y - im * z;
      im = re * z + im * y;
      re = t;
    }
    T hy = T(1), hz = T(0);
    if (fc.m > 1) {
      T rp = y, ip = z;
      for (int k = 2; k < fc.m; ++k) {
        const T t = rp * y - ip * z;
        ip = rp * z + ip * y;
        rp = t;
      }
      hy = T(fc.m) * rp;
      hz = -T(fc.m) * ip;
    }
    x.h = re;
    const T w1 = ((y - ry) * hy + (z - rz) * hz) * p.i1;
    const T w2 = ((y + ry) * hy + (z + rz) * hz) * p.i2;
    x.ws = w1 + w2;
    x.wd = w1 - w2;
  } else {
    x.h = T(1);
    x.ws = T(0);
    x.wd = T(0);
  }
  x.bs = (g.p1 + g.p2) - g.phi0 * s.d1 * l1 * p.t0;
  x.bd = (g.p1 - g.p2) + T(2) * g.phi0 * s.d1 * m1 * x.he;
  x.gs = s.e * x.bs;
  x.gd = s.e * x.bd;
  const T xs = T(0.5) * (x.gs * x.fs * x.hc + x.gd * x.fd * x.mc);
  x.xh = T(0.5) * (x.gs * x.ws + x.gd * x.wd);
  const T yh = T(0.5) * (x.fs * x.ws + x.fd * x.wd);
  x.lf = x.h * x.lfs + T(2) * yh;
  x.f = x.fsv * x.h;
  x.psi = s.psi * x.f;
  x.lap = x.f * s.lap + T(2) * (x.h * xs + x.fsv * x.xh) + s.psi * x.lf;
}

// Adjoint of ex_forward and of the top beneath it for cotangents (dpsi,
// dlap): the epilogue gives the ground top's cotangents (top_adjoint's
// inputs) and those of (gs, gd), whose additions through the bounded
// correction and the GZ pair join top_adjoint's result; the nodes'
// cotangents go to dc1, dc2, dn0 (0 where absent).
template <typename T>
__device__ __forceinline__ TopGrad<T> ex_adjoint(Factors fc, T a, T b, T l1,
                                                 T m1, T dpsi, T dlap,
                                                 const GZ<T>& g,
                                                 const Point<T>& p,
                                                 const Top<T>& s,
                                                 const Ex<T>& x, T& dc1,
                                                 T& dc2, T& dn0) {
  const T dpsi_b = dpsi * x.f + dlap * x.lf;
  const T dlap_b = dlap * x.f;
  const T dgs = dlap * (x.h * x.fs * x.hc + x.fsv * x.ws);
  const T dgd = dlap * (x.h * x.fd * x.mc + x.fsv * x.wd);
  const T dfsv = x.h * (dpsi * s.psi + dlap * s.lap) + T(2) * dlap * x.xh;
  const T dfs = dlap * (x.h * x.gs * x.hc + s.psi * x.ws);
  const T dfd = dlap * (x.h * x.gd * x.mc + s.psi * x.wd);
  const T dlfs = dlap * s.psi * x.h;
  T dq, dq1;
  dn0 = T(0);
  if (fc.ang) {
    dn0 = -(dfsv * x.q + dfs * x.q1 + dlfs * x.lq);
    dq = dfsv * x.aa + dfd * T(2) * x.he + dlfs * p.el2;
    dq1 = dfs * x.aa + dlfs * x.aa * x.sp;
  } else {
    dq = dfsv;
    dq1 = dfs + dlfs * x.sp;
  }
  dc1 = T(0);
  dc2 = T(0);
  if (fc.rad == 1) {
    dc1 = -dq;
  } else if (fc.rad == 2) {
    dc1 = -(dq * x.n2 + dq1);
    dc2 = -(dq * x.n1 + dq1);
  }
  TopGrad<T> r = top_adjoint(a, b, l1, m1, dpsi_b, dlap_b, g, p, s);
  // gs = e bs, gd = e bd through e, d1 (th), phi0, p1, p2, l1 and m1
  const T c = cap<T>();
  const T de = dgs * x.bs + dgd * x.bd;
  const T k = T(2) * dgd * m1 * x.he - dgs * l1 * p.t0;
  const T dphi0 = s.e * s.d1 * k;
  const T dd1 = s.e * g.phi0 * k;
  const T dl1 = -dgs * s.e * g.phi0 * s.d1 * p.t0;
  const T dm1 = T(2) * dgd * s.e * g.phi0 * s.d1 * x.he;
  const T dp1 = s.e * (dgs + dgd);
  const T dp2 = s.e * (dgs - dgd);
  const T dth = de * s.e * c - T(2) * s.th * dd1;
  r.dq0 = r.dq0 + dth * s.d1 / c;
  r.dl1 = r.dl1 + dl1;
  r.dm1 = r.dm1 + dm1;
  const T dfa = dphi0 - dp1 * a - dp2 * b;
  const T dfb = dphi0 - dp1 * b - dp2 * a;
  r.da = r.da + (-dp1 * g.fa - dp2 * g.fb - p.r1 * g.fa * dfa -
                 p.r2 * g.fb * dfb);
  r.db = r.db + (-dp1 * g.fb - dp2 * g.fa - p.r2 * g.fa * dfa -
                 p.r1 * g.fb * dfb);
  return r;
}

// The node inputs of point p where the factors read them (live points;
// zero otherwise, and for the pad lanes).
template <typename S, typename T>
__device__ __forceinline__ void load_nodes(Factors fc, bool live, int p,
                                           const S* __restrict__ c1,
                                           const S* __restrict__ c2,
                                           const S* __restrict__ n0, T& v1,
                                           T& v2, T& v0) {
  v1 = live && fc.rad > 0 ? kern::ld(c1[p]) : T(0);
  v2 = live && fc.rad > 1 ? kern::ld(c2[p]) : T(0);
  v0 = live && fc.ang ? kern::ld(n0[p]) : T(0);
}

}  // namespace sep

// C entry points return cudaGetLastError() of their launch; this names it.
extern "C" const char* separable_error_string(int err);
