// The forward (psi, lap psi) kernels of the symmetric family, shared by
// K2-fwd (train_fwd.cu) and K3 (residual_fwd.cu).
//
// Per point: two weight-shared sigmoid-MLP branches 2 -> H -> H -> 1 (the
// second mirrored at x -> -x) on the envelope stacks of e^{-a r1},
// e^{-a r2}, combined as b+ + P b- + ob and gated by g, plus the
// Guillemin-Zener pair e^{-a r1 - b r2} + P e^{-a r2 - b r1} (train.cuh).
//
// A compile-time source policy says where a point's exponents (a, b) and
// gate g come from:
// - ReadSource (K2): a, b and g are read per point from device memory;
// - GateSource (K3, the reference-parity model): a = 1 and b = 0, so the GZ
//   pair is the LCAO pair e^{-r} (1 - 2/r), the envelopes' own stacks; g is
//   gate(R), the 1 -> Hg -> 1 sigmoid MLP of the point's R, evaluated in
//   the kernel from gate weights staged in shared memory (Hg a run-time
//   argument). The gate's weights follow the MLP's in the packed vector:
//   gw1 (Hg) | gb1 (Hg) | gw2 (Hg) | gb2 (1).
// Both kernels take the same arguments; K2 passes hg = 0, K3 passes null a,
// b and g.
//
// Design, by type:
// - float32 (train_fwd_point_kernel): one thread a point; nothing but the
//   two outputs touches device memory. The weights are loaded once per block
//   into shared memory, where every read is a broadcast (one load per 4
//   FMAs); each branch keeps its H first-layer 4-stacks in registers (fully
//   unrolled, H a template parameter). The two branches run one after the
//   other and the second layer's units in a rolled loop: evaluated together,
//   or unrolled, they held too much in registers and spilled. K3's gate runs
//   in the same thread after the branches, its units in a rolled loop.
// - float64 (train_fwd_tile_kernel, train_tile.cuh): a block of 256 threads
//   takes a tile of 32 points (16 at H = 32) at a time: the envelope
//   geometry one thread a (branch, point) pair; the first layer TPP threads
//   a pair, H / TPP units each; the second layer's L = A W2 on the float64
//   tensor cores, written over A; its sigmoid units and the branch outputs
//   per pair; psi and lap one thread a point. K3's gate runs beside the
//   first layer, on all 256 threads: a point's Hg units split over its 2 TPP
//   pair lanes (8 or 16), summed per pair by a butterfly, the two pairs'
//   sums added by the point's thread. Per-point R varies within a tile; the
//   gate is never hoisted to one value a tile.
// - bfloat16: the float32 kernel on bfloat16 tensors (storage type S =
//   __nv_bfloat16, compute type float): every value loaded into float, the
//   float32 arithmetic, psi and lap psi rounded once as they are stored.
// Lanes past n evaluate the finite pad point (1, 1, 1; R = 1, and a = b =
// g = 1 for K2) and store nothing.
#pragma once

#include "train_tile.cuh"

namespace trn {

constexpr int kPointThreads = 128;  // the float32 kernel: one thread a point

struct ReadSource {
  static constexpr bool kGate = false;
};

struct GateSource {
  static constexpr bool kGate = true;
};

// Sum over the gate units j = j0, j0 + step, ... < hg of
// sigmoid(R gw1[j] + gb1[j]) gw2[j] (gw: the staged gate weights).
template <typename T>
__device__ __forceinline__ T gate_units(const T* gw, int hg, T rv, int j0,
                                        int step) {
  T s = T(0);
#pragma unroll 1
  for (int j = j0; j < hg; j += step)
    s += m_sigmoid(rv * gw[j] + gw[hg + j]) * gw[2 * hg + j];
  return s;
}

// Shared memory of K3's float64 tile kernel: the tile's, then the points'
// R [P], the pairs' gate sums [2P] and the gate weights [3 hg + 1].
template <int H>
__host__ __device__ constexpr int gate_tile_smem_elems(int hg) {
  return tile_smem_elems<H>(1) + 3 * Tile<H>::P + 3 * hg + 1;
}

// S: the tensors' storage type (float or __nv_bfloat16); T = compute_t<S>
template <typename S, int H, typename Src, typename T = kern::compute_t<S>>
__global__ void __launch_bounds__(kPointThreads)
    train_fwd_point_kernel(const S* __restrict__ x, const S* __restrict__ y,
                           const S* __restrict__ z, const S* __restrict__ r,
                           const S* __restrict__ a, const S* __restrict__ b,
                           const S* __restrict__ g, const S* __restrict__ w,
                           S* __restrict__ psi, S* __restrict__ lap, int n,
                           T psym, T ry, T rz, int hg) {
  using kern::ld;
  using L = Layout<H>;
  __shared__ T sw[L::SIZE];
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sgw = reinterpret_cast<T*>(smem_raw);  // the gate's weights (K3)
  for (int i = threadIdx.x; i < L::SIZE; i += kPointThreads)
    sw[i] = ld(w[i]);
  if constexpr (Src::kGate)
    for (int i = threadIdx.x; i < 3 * hg + 1; i += kPointThreads)
      sgw[i] = ld(w[L::SIZE + i]);
  __syncthreads();

  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  const bool live = p < n;
  const T one = T(1);
  const T xv = live ? ld(x[p]) : one, yv = live ? ld(y[p]) : one;
  const T zv = live ? ld(z[p]) : one, rv = live ? ld(r[p]) : one;
  T av = one, bv = T(0);
  if constexpr (!Src::kGate) {
    av = live ? ld(a[p]) : one;
    bv = live ? ld(b[p]) : one;
  }

  // the GZ pair first, then one branch after the other: evaluated together
  // the two branches' stacks would not fit the registers
  Env<T> ep;
  branch_envelopes(xv, yv, zv, rv, ry, rz, av, false, ep);
  T gzv, gzl;
  if constexpr (Src::kGate) {
    // a = 1, b = 0: the LCAO pair, the direct branch's envelope stacks
    gzv = ep.f1 + psym * ep.f2;
    gzl = ep.l1 + psym * ep.l2;
  } else {
    const GZ<T> q = gz(av, bv, ep);
    gzv = q.v1 + psym * q.v2;
    gzl = q.v1 * q.s1 + psym * (q.v2 * q.s2);
  }
  T nnv = sw[L::OB], nnl = T(0);
#pragma unroll 1
  for (int m = 0; m < 2; ++m) {
    Env<T> e;
    branch_envelopes(xv, yv, zv, rv, ry, rz, av, m == 1, e);
    T a0[H], a1[H], a2[H], a3[H];
    layer1<T, H>(sw, e, a0, a1, a2, a3);
    // the second layer's units in a loop kept rolled: unrolled, the
    // compiler loads the weights of many units ahead and spills
    T v = T(0), l = T(0);
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const Unit2<T> u = unit2<T, H>(sw, k, e, a0, a1, a2, a3);
      v += u.bv * sw[L::OW + k];
      l += u.bl * sw[L::OW + k];
    }
    const T pb = m == 0 ? one : psym;
    nnv += pb * v;
    nnl += pb * l;
  }
  if constexpr (Src::kGate) {
    const T gv = gate_units(sgw, hg, rv, 0, 1) + sgw[3 * hg];
    if (live) {
      psi[p] = kern::st<S>(nnv * gv + gzv);
      lap[p] = kern::st<S>(nnl * gv + gzl);
    }
  } else {
    if (live) {
      const T gv = ld(g[p]);
      psi[p] = kern::st<S>(nnv * gv + gzv);
      lap[p] = kern::st<S>(nnl * gv + gzl);
    }
  }
}

template <typename T, int H, typename Src>
__global__ void __launch_bounds__(kTileThreads, 2)
    train_fwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ y,
                          const T* __restrict__ z, const T* __restrict__ r,
                          const T* __restrict__ a, const T* __restrict__ b,
                          const T* __restrict__ g, const T* __restrict__ w,
                          T* __restrict__ psi, T* __restrict__ lap, int n,
                          T psym, T ry, T rz, int hg) {
  using TL = Tile<H>;
  using L = Layout<H>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sW2 = sw + TL::WSP;           // [H][LD] W2
  T* sA = sW2 + H * TL::LD;        // [8P][LD] first-layer stacks, then L
  T* sV = sA + TL::ROWS * TL::LD;  // [slot][2P] per-pair vectors
  // K3 (gate_tile_smem_elems): the points' R, the pairs' gate sums, the
  // gate's weights
  T* sR = sV + kSlots * TL::BP;
  T* sG = sR + TL::P;
  T* sgw = sG + TL::BP;
  tile_load_weights<T, H>(w, sw, sW2);
  if constexpr (Src::kGate)
    for (int i = threadIdx.x; i < 3 * hg + 1; i += kTileThreads)
      sgw[i] = w[L::SIZE + i];
  __syncthreads();

  const int bp = my_pair<H>(), q = my_lane<H>();
  const int tiles = (n + TL::P - 1) / TL::P;
  const T one = T(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (threadIdx.x < TL::BP) {
      if constexpr (Src::kGate)
        tile_unit_envelopes<T, H>(x, y, z, r, tile, n, ry, rz, sV, sR);
      else
        tile_envelopes<T, H>(x, y, z, r, a, g, nullptr, nullptr, tile, n,
                             psym, ry, rz, sV);
    }
    __syncthreads();
    const Env<T> e = tile_env<T, H>(sV, bp);
    tile_layer1<T, H>(sw, e, sA);
    if constexpr (Src::kGate) {
      // the gate of the pair's point: its units split over the point's
      // 2 TPP lanes (lane q of branch m takes units m TPP + q + 2 TPP i)
      const T part = pair_sum<H>(gate_units(
          sgw, hg, sR[bp % TL::P], (bp / TL::P) * TL::TPP + q, 2 * TL::TPP));
      if (q == 0) sG[bp] = part;
    }
    __syncthreads();
    tile_product<T, H, false>(sA, sW2, sA);
    __syncthreads();
    // the second layer's units at the thread's pair, and the branch output
    T ov = T(0), ol = T(0);
#pragma unroll
    for (int i = 0; i < TL::UPT; ++i) {
      const int k = q + TL::TPP * i;
      const Unit2<T> u = unit2_act(
          sA[tile_row<H>(bp, 0) * TL::LD + k] + sw[L::B2 + k],
          sA[tile_row<H>(bp, 1) * TL::LD + k],
          sA[tile_row<H>(bp, 2) * TL::LD + k],
          sA[tile_row<H>(bp, 3) * TL::LD + k], e.c12);
      ov += u.bv * sw[L::OW + k];
      ol += u.bl * sw[L::OW + k];
    }
    ov = pair_sum<H>(ov);
    ol = pair_sum<H>(ol);
    if (q == 0) {
      sV[kOv * TL::BP + bp] = ov;
      sV[kOl * TL::BP + bp] = ol;
    }
    __syncthreads();
    // one thread a point: the gated network and the GZ pair
    if (threadIdx.x < TL::P) {
      const int t = threadIdx.x;
      const int p = tile * TL::P + t;
      const bool live = p < n;
      const Env<T> ep = tile_env<T, H>(sV, t);
      const T* bv = sV + kOv * TL::BP + t;  // both branches' outputs
      const T* bl = sV + kOl * TL::BP + t;
      const T nnv = sw[L::OB] + bv[0] + psym * bv[TL::P];
      const T nnl = bl[0] + psym * bl[TL::P];
      if constexpr (Src::kGate) {
        // a = 1, b = 0: the LCAO pair, the direct branch's envelope stacks
        const T gv = sG[t] + sG[TL::P + t] + sgw[3 * hg];
        if (live) {
          psi[p] = nnv * gv + ep.f1 + psym * ep.f2;
          lap[p] = nnl * gv + ep.l1 + psym * ep.l2;
        }
      } else {
        const GZ<T> gq = gz(live ? a[p] : one, live ? b[p] : one, ep);
        if (live) {
          const T gv = g[p];
          psi[p] = nnv * gv + gq.v1 + psym * gq.v2;
          lap[p] = nnl * gv + gq.v1 * gq.s1 + psym * (gq.v2 * gq.s2);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace trn
