// The R-heads kernel pair of the symmetric family: E(R), the gate g(R), the
// orbital exponent alpha(R) and the GZ exponent b(R) at each point's own R,
// and their adjoint. Included by train_fwd.cu (rheads_fwd_*) and
// train_bwd.cu (rheads_bwd_*), so K2's two libraries carry them.
//
// Replaces: no Pallas kernel. The JAX package evaluates these heads as
// plain jnp operations beside its K2 call and leaves their fusion to XLA
// (pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_train.py,
// psi_lap_train); the port ran them as ~70 torch operations a step on
// (n, He) tensors (models/ansatz.py energy, gate, orbital_exponent,
// gz_exponent), which this pair replaces on the flat-points entry
// (ops/rheads.py RHeadsKernel).
//
// The heads, on the point's R (r):
//   E = sig(sig(r e1w + e1b) e2w + e2b) . eoutw + eoutb   (1 -> He -> He -> 1)
//   g = sig(r gw1 + gb1) . gw2 + gb2                      (1 -> Hg -> 1)
//   a = 1.5 + 0.75 tanh(ha), ha = sig(r aw1 + ab1) . aw2 + ab2   (1 -> Ha -> 1)
//   b = 0.75 (1 + tanh(hb)) for P = +1, (a - 0.25) (1 + tanh(hb)) / 2 for
//       P = -1, hb the beta head's output as ha
// with a = 1 when the params hold no alpha head and b = 0 when they hold no
// beta head (hidden width 0).
//
// What bounds it on an H100: operations. A point reads R (and 4
// cotangents in the backward) and writes 4 values (1 in the backward, dr),
// against ~2 He^2 + 40 (He + Hg + Ha + Hb) operations forward, a sigmoid
// counted as ~10, and ~3x that backward with the recompute: 4.6k and ~14k
// at the paper widths (He 32, Hg 10, Ha = Hb = 8), ~230 and ~700
// operations a byte in float32.
//
// Design (one thread a point; the same code for float64, float32, and
// bfloat16 on float32 arithmetic):
// - Nothing (n, He)-shaped touches device memory. The weights (~1.3k
//   values) go to shared memory once a block; every read of them is a
//   broadcast. E's first-layer sigmoids s1 stay in registers (He a template
//   parameter, fully unrolled); the second layer runs in groups of 4 units,
//   W2 read 4 values a 16-byte load.
// - The backward recomputes the forward in registers. The cotangents of
//   E's second-layer pre-activations dz2 and the sigmoids s1 go to the
//   point's rows of two shared [128][He + 4] buffers; dW2 += s1^T dz2 is a
//   register-blocked product over the tile: each thread owns a 4 x 4 block
//   of dW2 and a fixed slice of the tile's points, two 16-byte loads per
//   16 FMAs, and keeps it across its tiles (K2-bwd's float32 dW2). The
//   other weight gradients (vectors of He, Hg, Ha, Hb units) are sums over
//   the warp by fixed shuffle trees (common.cuh warp_unit_sum) into
//   per-warp sums in shared memory. The sums over points run in a FIXED
//   order with no atomics: a block walks the tiles blockIdx, blockIdx +
//   grid, ... (the wrapper's _cuda.grid_blocks) and writes one row of
//   partial weight gradients, which the wrapper sums in their order; two
//   launches agree bit for bit.
// - Float32 arithmetic is IEEE (expf, tanhf and a rounded divide; no fast
//   math). Lanes past n evaluate R = 1 with zero cotangents, which add
//   exactly 0 to every sum.
//
// Packed weights (the wrapper's order, ops/rheads.py head_weights):
//   e1w (He) | e1b (He) | e2w (He, He) | e2b (He) | eoutw (He) | eoutb (1) |
//   gw1 (Hg) | gb1 (Hg) | gw2 (Hg) | gb2 (1) | [alpha: 3 Ha + 1] |
//   [beta: 3 Hb + 1]
// The rows of partial weight gradients hold the same layout.
#pragma once

#include <type_traits>

#include "train.cuh"

namespace rhd {

using kern::ld;
using kern::m_tanh;
using trn::m_sigmoid;

constexpr int kThreads = 128;  // points (threads) a block
constexpr int kWarps = kThreads / 32;

// Offsets into the packed weights: E's at compile time, the rank-1 heads'
// (1 -> h -> 1) at run time.
template <int HE>
struct ELayout {
  static constexpr int W1 = 0;
  static constexpr int B1 = HE;
  static constexpr int W2 = 2 * HE;
  static constexpr int B2 = 2 * HE + HE * HE;
  static constexpr int OW = 3 * HE + HE * HE;
  static constexpr int OB = 4 * HE + HE * HE;
  static constexpr int SIZE = HE * HE + 4 * HE + 1;
};

__host__ __device__ constexpr int rank1_size(int h) {
  return h > 0 ? 3 * h + 1 : 0;
}

// The widths of the rank-1 heads (0: absent) and their offsets.
struct Heads {
  int hg, ha, hb;
  int g0, a0, b0, size;
};

template <int HE>
__host__ __device__ inline Heads heads_of(int hg, int ha, int hb) {
  Heads h{hg, ha, hb, 0, 0, 0, 0};
  h.g0 = ELayout<HE>::SIZE;
  h.a0 = h.g0 + rank1_size(hg);
  h.b0 = h.a0 + rank1_size(ha);
  h.size = h.b0 + rank1_size(hb);
  return h;
}

template <typename T>
__device__ __forceinline__ void load4(const T* src, T* v) {
  if constexpr (std::is_same<T, float>::value) {
    kern::load4(src, v);
  } else {
    const double2 p = *reinterpret_cast<const double2*>(src);
    const double2 q = *reinterpret_cast<const double2*>(src + 2);
    v[0] = p.x;
    v[1] = p.y;
    v[2] = q.x;
    v[3] = q.y;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const T* v) {
  if constexpr (std::is_same<T, float>::value) {
    kern::store4(dst, v);
  } else {
    *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(dst + 2) = make_double2(v[2], v[3]);
  }
}

// A rank-1 head's output: sum_j sig(r w1[j] + b1[j]) w2[j] + b2 (hw: its
// staged weights w1 | b1 | w2 | b2).
template <typename T>
__device__ __forceinline__ T rank1_head(const T* hw, int h, T rv) {
  T s = T(0);
#pragma unroll 1
  for (int j = 0; j < h; ++j)
    s += m_sigmoid(rv * hw[j] + hw[h + j]) * hw[2 * h + j];
  return s + hw[3 * h];
}

// E's first layer: s1 = sig(r w1 + b1).
template <typename T, int HE>
__device__ __forceinline__ void e_layer1(const T* sw, T rv, T (&s1)[HE]) {
  using L = ELayout<HE>;
#pragma unroll
  for (int k = 0; k < HE; ++k) s1[k] = m_sigmoid(rv * sw[L::W1 + k] +
                                                 sw[L::B1 + k]);
}

// E's second-layer pre-activations of units j0 .. j0 + 3 (bias added).
template <typename T, int HE>
__device__ __forceinline__ void e_layer2(const T* sw, const T (&s1)[HE],
                                         int j0, T* z) {
  using L = ELayout<HE>;
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < HE; ++k) {
    T w[4];
    load4(sw + L::W2 + k * HE + j0, w);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[jj] += s1[k] * w[jj];
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) z[jj] = acc[jj] + sw[L::B2 + j0 + jj];
}

// The four heads at one point: (E, a, b, g).
template <typename T, int HE>
__device__ __forceinline__ void heads_forward(const T* sw, const Heads& hd,
                                              T rv, T psym, T& e, T& a, T& b,
                                              T& g) {
  using L = ELayout<HE>;
  T s1[HE];
  e_layer1<T, HE>(sw, rv, s1);
  T es = T(0);
#pragma unroll 1
  for (int j0 = 0; j0 < HE; j0 += 4) {
    T z[4];
    e_layer2<T, HE>(sw, s1, j0, z);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      es += m_sigmoid(z[jj]) * sw[L::OW + j0 + jj];
  }
  e = es + sw[L::OB];
  g = rank1_head(sw + hd.g0, hd.hg, rv);
  a = hd.ha > 0 ? T(1.5) + T(0.75) * m_tanh(rank1_head(sw + hd.a0, hd.ha, rv))
                : T(1);
  b = T(0);
  if (hd.hb > 0) {
    const T tb = T(1) + m_tanh(rank1_head(sw + hd.b0, hd.hb, rv));
    b = psym >= T(0) ? T(0.75) * tb : (a - T(0.25)) * T(0.5) * tb;
  }
}

// S: the tensors' storage type; T = compute_t<S>. One thread a point, one
// block a tile of kThreads points.
template <typename S, int HE, typename T = kern::compute_t<S>>
__global__ void __launch_bounds__(kThreads)
    rheads_fwd_kernel(const S* __restrict__ r, const S* __restrict__ w,
                      S* __restrict__ e_out, S* __restrict__ a_out,
                      S* __restrict__ b_out, S* __restrict__ g_out, int n,
                      int hg, int ha, int hb, T psym) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  const Heads hd = heads_of<HE>(hg, ha, hb);
  for (int i = threadIdx.x; i < hd.size; i += kThreads) sw[i] = ld(w[i]);
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  T e, a, b, g;
  heads_forward<T, HE>(sw, hd, ld(r[p]), psym, e, a, b, g);
  e_out[p] = kern::st<S>(e);
  a_out[p] = kern::st<S>(a);
  b_out[p] = kern::st<S>(b);
  g_out[p] = kern::st<S>(g);
}

// ---------------------------------------------------------------------------
// backward

// The owner lanes of a warp add its sums over the lanes of C consecutive
// units' values v (one point a lane) to sums[slot], for slots < lim only
// (units past a head's width hold zeros).
template <int C, typename T>
__device__ __forceinline__ void add_sums(T* v, T* sums, int lane, int lim) {
  const int slot = kern::warp_unit_sum<C, 1>(v, lane);
  if (lane < C && slot < lim) sums[slot] += v[0];
}

template <typename T>
__device__ __forceinline__ void add_sum1(T v, T* sum, int lane) {
  T c[1] = {v};
  kern::warp_unit_sum<1, 1>(c, lane);
  if (lane == 0) *sum += c[0];
}

// Adjoint of a rank-1 head for its output's cotangent dh: the weight
// gradients to the warp's sums (the head's own w1 | b1 | w2 | b2 block),
// r's cotangent to dr. Units in groups of 4; the warp's lanes run the same
// trip count (h is uniform).
template <typename T>
__device__ __forceinline__ void rank1_adjoint(const T* hw, int h, T rv, T dh,
                                              T* sums, int lane, T& dr) {
#pragma unroll 1
  for (int j0 = 0; j0 < h; j0 += 4) {
    T tw1[4], tb1[4], tw2[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      const bool in = j < h;
      const T w1 = in ? hw[j] : T(0), w2 = in ? hw[2 * h + j] : T(0);
      const T s = m_sigmoid(rv * w1 + (in ? hw[h + j] : T(0)));
      const T dz = dh * w2 * s * (T(1) - s);
      tw1[jj] = dz * rv;
      tb1[jj] = dz;
      tw2[jj] = in ? dh * s : T(0);
      dr += dz * w1;
    }
    add_sums<4>(tw1, sums + j0, lane, h - j0);
    add_sums<4>(tb1, sums + h + j0, lane, h - j0);
    add_sums<4>(tw2, sums + 2 * h + j0, lane, h - j0);
  }
  add_sum1(dh, sums + 3 * h, lane);
}

// The backward's work layout at E width HE: 4 x 4 blocks of dW2, slices of
// the tile's points, the staging rows' stride.
template <int HE>
struct Bwd {
  static constexpr int RS = HE + 4;             // a point's row of s1, dz2
  static constexpr int NB = (HE / 4) * (HE / 4);  // 4 x 4 blocks of dW2
  static constexpr int NS = kThreads / NB;        // slices of the points
  static_assert(NS * NB == kThreads, "every thread owns a block and a slice");
  static_assert(NS * HE * HE <= 2 * kThreads * RS,
                "the dW2 staging fits the two buffers");
};

// Per-warp sums hold every weight gradient but dW2: the packed layout with
// the He x He block taken out.
template <int HE>
__host__ __device__ inline int sums_size(const Heads& hd) {
  return hd.size - HE * HE;
}

template <int HE>
__host__ __device__ inline int bwd_smem_elems(const Heads& hd) {
  return ((hd.size + 3) & ~3) + 2 * kThreads * Bwd<HE>::RS +
         kWarps * sums_size<HE>(hd);
}

template <typename S, int HE, typename T = kern::compute_t<S>>
__global__ void __launch_bounds__(kThreads,
                                  std::is_same<T, double>::value ? 2 : 3)
    rheads_bwd_kernel(const S* __restrict__ r, const S* __restrict__ w,
                      const S* __restrict__ de, const S* __restrict__ da,
                      const S* __restrict__ db, const S* __restrict__ dg,
                      T* __restrict__ partials, S* __restrict__ dr_out, int n,
                      int hg, int ha, int hb, T psym) {
  using L = ELayout<HE>;
  using B = Bwd<HE>;
  constexpr int RS = B::RS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Heads hd = heads_of<HE>(hg, ha, hb);
  const int vs = sums_size<HE>(hd);
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sA = sw + ((hd.size + 3) & ~3);  // [kThreads][RS] s1
  T* sG = sA + kThreads * RS;         // [kThreads][RS] dz2
  T* sS = sG + kThreads * RS;         // [warp][vs] per-warp sums
  for (int i = threadIdx.x; i < hd.size; i += kThreads) sw[i] = ld(w[i]);
  for (int i = threadIdx.x; i < kWarps * vs; i += kThreads) sS[i] = T(0);
  __syncthreads();

  const int tid = threadIdx.x, lane = tid % 32;
  // the warp's sums: e1w, e1b at 0; e2b, eoutw, eoutb and the rank-1
  // heads at their packed offsets less He^2 (post: the offset of e2b)
  T* sums = sS + (tid / 32) * vs;
  T* post = sums + 2 * HE;
  const int bi = (tid % B::NB) / (HE / 4), bk = (tid % B::NB) % (HE / 4);
  const int sl = tid / B::NB;
  T dw[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) dw[u][v] = T(0);
  T* rowA = sA + tid * RS;
  T* rowG = sG + tid * RS;

  const int tiles = (n + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p = tile * kThreads + tid;
    const bool live = p < n;
    const T rv = live ? ld(r[p]) : T(1);
    const T ce = live && de ? ld(de[p]) : T(0);
    T ca = live && da ? ld(da[p]) : T(0);
    const T cb = live && db ? ld(db[p]) : T(0);
    const T cg = live && dg ? ld(dg[p]) : T(0);
    T dr = T(0);

    // the exponents: b reads a in the ungerade sector
    T ta = T(0), av = T(1), dhb = T(0);
    if (hd.ha > 0) {
      ta = m_tanh(rank1_head(sw + hd.a0, hd.ha, rv));
      av = T(1.5) + T(0.75) * ta;
    }
    if (hd.hb > 0) {
      const T tb = m_tanh(rank1_head(sw + hd.b0, hd.hb, rv));
      if (psym >= T(0)) {
        dhb = cb * T(0.75) * (T(1) - tb * tb);
      } else {
        dhb = cb * ((av - T(0.25)) * T(0.5)) * (T(1) - tb * tb);
        ca += cb * T(0.5) * (T(1) + tb);
      }
    }
    rank1_adjoint(sw + hd.g0, hd.hg, rv, cg, post + (hd.g0 - L::B2), lane, dr);
    if (hd.ha > 0)
      rank1_adjoint(sw + hd.a0, hd.ha, rv, ca * T(0.75) * (T(1) - ta * ta),
                    post + (hd.a0 - L::B2), lane, dr);
    if (hd.hb > 0)
      rank1_adjoint(sw + hd.b0, hd.hb, rv, dhb, post + (hd.b0 - L::B2), lane, dr);

    // E: s1 to the point's row of A, dz2 to its row of G; the eout and e2b
    // sums
    T s1[HE], dz2[HE];
    e_layer1<T, HE>(sw, rv, s1);
#pragma unroll
    for (int j0 = 0; j0 < HE; j0 += 4) store4(rowA + j0, s1 + j0);
#pragma unroll
    for (int j0 = 0; j0 < HE; j0 += 4) {
      T z[4], tow[4], tb2[4];
      e_layer2<T, HE>(sw, s1, j0, z);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T s2 = m_sigmoid(z[jj]);
        tow[jj] = ce * s2;
        dz2[j0 + jj] = ce * sw[L::OW + j0 + jj] * s2 * (T(1) - s2);
        tb2[jj] = dz2[j0 + jj];
      }
      store4(rowG + j0, dz2 + j0);
      add_sums<4>(tow, post + (L::OW - L::B2) + j0, lane, 4);
      add_sums<4>(tb2, post + j0, lane, 4);
    }
    add_sum1(ce, post + (L::OB - L::B2), lane);
    // ds1 = W2 dz2, then the first layer's adjoint, in groups of 4 units
#pragma unroll
    for (int k0 = 0; k0 < HE; k0 += 4) {
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int j0 = 0; j0 < HE; j0 += 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          T wv[4];
          load4(sw + L::W2 + (k0 + kk) * HE + j0, wv);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[kk] += wv[jj] * dz2[j0 + jj];
        }
      }
      T tw1[4], tb1[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = k0 + kk;
        const T dz1 = acc[kk] * s1[k] * (T(1) - s1[k]);
        tw1[kk] = dz1 * rv;
        tb1[kk] = dz1;
        dr += dz1 * sw[L::W1 + k];
      }
      add_sums<4>(tw1, sums + L::W1 + k0, lane, 4);
      add_sums<4>(tb1, sums + L::B1 + k0, lane, 4);
    }
    if (dr_out && live) dr_out[p] = kern::st<S>(dr);
    __syncthreads();
    // dW2 += s1^T dz2 over the points of the thread's slice
    for (int pp = sl; pp < kThreads; pp += B::NS) {
      T av4[4], gv4[4];
      load4(sA + pp * RS + 4 * bi, av4);
      load4(sG + pp * RS + 4 * bk, gv4);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) dw[u][v] += av4[u] * gv4[v];
    }
    __syncthreads();
  }

  // the block's row of partial weight gradients, the slices and the warps
  // combined in a fixed order: dW2 [slice][He][He] staged over A and G
  T* st = sA;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      st[(sl * HE + 4 * bi + u) * HE + 4 * bk + v] = dw[u][v];
  __syncthreads();
  T* part = partials + static_cast<size_t>(blockIdx.x) * hd.size;
  for (int o = tid; o < hd.size; o += kThreads) {
    T acc = T(0);
    if (o >= L::W2 && o < L::B2) {
      for (int s = 0; s < B::NS; ++s) acc += st[s * HE * HE + o - L::W2];
    } else {
      const int v = o < L::W2 ? o : o - HE * HE;
      for (int k = 0; k < kWarps; ++k) acc += sS[k * vs + v];
    }
    part[o] = acc;
  }
}

}  // namespace rhd
