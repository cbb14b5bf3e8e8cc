// Tile machinery of the float64 symmetric-family kernels (K2-fwd and K2-bwd
// in float64: train_fwd.cu, train_bwd.cu).
//
// Work layout. A block of kTileThreads threads owns a tile of P points at a
// time, so 2P (branch, point) pairs: the direct branch and the one mirrored
// at x -> -x. The per-pair and per-point scalar work (envelope geometry, the
// GZ pair and their adjoints) runs one thread a pair or a point; what the
// MLP needs of it, and what it returns, passes through per-pair vectors in
// shared memory. For the MLP, TPP consecutive threads share a pair, the
// units q, q + TPP, ... each (q the thread's lane in its group).
//
// Both branches' first-layer 4-stacks form one [8P, H] tile A in shared
// memory, row (4 m + c) P + p for component c of point p in branch m. The
// H x H products
//   L = A W2 (forward),  dA = G W2^T and dW2 += A^T G (backward)
// run on the tile: on the float64 tensor cores (mma.sync m8n8k4 through
// nvcuda::wmma fragments of double) where 8 divides H, as FMAs from shared
// memory at H = 4. Rows of the tiles and of W2 are padded to H + 4 values:
// the 8 rows a fragment (or a warp's pairs) touch then fall on distinct
// banks, and every fragment pointer stays 32-byte aligned.
#pragma once

#include <mma.h>

#include <type_traits>

#include "train.cuh"

namespace trn {

constexpr int kTileThreads = 256;  // threads a block
constexpr int kTileWarps = kTileThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int H>
struct Tile {
  static constexpr int P = H > 16 ? 16 : 32;      // points a tile
  static constexpr int BP = 2 * P;                // (branch, point) pairs
  static constexpr int TPP = kTileThreads / BP;   // threads a pair
  static constexpr int UPT = H / TPP;             // units a thread
  static constexpr int ROWS = 8 * P;              // rows of an [8P, H] tile
  static constexpr int LD = H + 4;                // their padded stride
  static constexpr int WSP = (Layout<H>::SIZE + 3) & ~3;  // padded weights
  static_assert(UPT >= 1 && UPT * TPP == H, "units split evenly");
  static_assert(BP % 32 == 0, "the pair lanes are whole warps");
};

// Per-pair vectors of a tile in shared memory, [slot][2P], pair m P + p:
// the branch's geometry and envelope stacks (Env), the exponent, its output
// cotangents (cv, cl, times P in the mirrored branch), and what the MLP
// returns: the branch's (value, laplacian) and its share of da.
enum Slot { kR1, kR2, kI1, kI2, kC12, kF1, kG1, kL1, kF2, kG2, kL2, kA, kCv,
            kCl, kOv, kOl, kDa, kSlots };

// The H x H products on the float64 tensor cores?
template <typename T, int H>
__host__ __device__ constexpr bool use_mma() {
  return std::is_same<T, double>::value && H % 8 == 0;
}

// Shared memory of a tile kernel: the packed weights [WSP], W2 with padded
// rows [H][LD], `tiles` [ROWS][LD] tiles, the per-pair vectors.
template <int H>
__host__ __device__ constexpr int tile_smem_elems(int tiles) {
  using TL = Tile<H>;
  return TL::WSP + H * TL::LD + tiles * TL::ROWS * TL::LD +
         kSlots * TL::BP;
}

template <typename T, int H>
__device__ __forceinline__ void tile_load_weights(const T* __restrict__ w,
                                                  T* sw, T* sW2) {
  using L = Layout<H>;
  using TL = Tile<H>;
  for (int i = threadIdx.x; i < L::SIZE; i += kTileThreads) {
    const T v = w[i];
    sw[i] = v;
    if (i >= L::W2 && i < L::B2)
      sW2[((i - L::W2) / H) * TL::LD + (i - L::W2) % H] = v;
  }
}

// The calling thread's pair and its lane in the pair's group.
template <int H>
__device__ __forceinline__ int my_pair() {
  return threadIdx.x / Tile<H>::TPP;
}

template <int H>
__device__ __forceinline__ int my_lane() {
  return threadIdx.x % Tile<H>::TPP;
}

// Row of component c of pair bp = m P + p in an [8P, H] tile.
template <int H>
__device__ __forceinline__ int tile_row(int bp, int c) {
  using TL = Tile<H>;
  return ((bp / TL::P) * 4 + c) * TL::P + bp % TL::P;
}

// Sum of v over the TPP lanes of a pair (a butterfly: every lane ends with
// the same bits, in a fixed order).
template <int H, typename T>
__device__ __forceinline__ T pair_sum(T v) {
#pragma unroll
  for (int off = 1; off < Tile<H>::TPP; off <<= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum over the pairs of a warp of each of the calling thread's unit values
// (v[i] for unit q + TPP i, q its lane in its pair's group), by recursive
// halving: at each level a lane keeps half its values, adds its partner's
// half of them and passes the other half on, so the UPT values cost UPT - 1
// exchanges; the levels past one value add whole values. v[0] ends as the
// warp's sum of unit q + TPP slot (the returned slot); the lanes below H
// hold distinct units. The order of every sum is fixed.
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

// warp_unit_sum of each of the thread's NV arrays of unit values, added by
// the owner lanes to the warp's sums in shared memory: array s to
// sums[s H + unit].
template <int H, int NV, typename T>
__device__ __forceinline__ void warp_unit_sums(T (&v)[NV][Tile<H>::UPT],
                                               T* sums) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int slot = warp_unit_sum<Tile<H>::UPT, Tile<H>::TPP>(v[s], lane);
    if (lane < H)
      sums[s * H + my_lane<H>() + Tile<H>::TPP * slot] += v[s][0];
  }
}

// The envelope lanes: thread bp < 2P evaluates pair bp of tile `tile` (the
// pad point past n, with zero cotangents) into the per-pair vectors.
// cotangents: whether dpsi and dlap are given (the backward).
template <typename T, int H>
__device__ __forceinline__ void tile_envelopes(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ z,
    const T* __restrict__ r, const T* __restrict__ a, const T* __restrict__ g,
    const T* __restrict__ dpsi, const T* __restrict__ dlap, int tile, int n,
    T psym, T ry, T rz, T* sV) {
  constexpr int P = Tile<H>::P, BP = Tile<H>::BP;
  const int bp = threadIdx.x;
  const int m = bp / P;
  const int p = tile * P + bp % P;
  const bool live = p < n;
  const T one = T(1);
  const T av = live ? a[p] : one;
  Env<T> e;
  branch_envelopes(live ? x[p] : one, live ? y[p] : one, live ? z[p] : one,
                   live ? r[p] : one, ry, rz, av, m == 1, e);
  T* v = sV + bp;
  v[kR1 * BP] = e.r1;
  v[kR2 * BP] = e.r2;
  v[kI1 * BP] = e.i1;
  v[kI2 * BP] = e.i2;
  v[kC12 * BP] = e.c12;
  v[kF1 * BP] = e.f1;
  v[kG1 * BP] = e.g1;
  v[kL1 * BP] = e.l1;
  v[kF2 * BP] = e.f2;
  v[kG2 * BP] = e.g2;
  v[kL2 * BP] = e.l2;
  v[kA * BP] = av;
  if (dpsi != nullptr) {
    const T gb = (live ? g[p] : one) * (m == 0 ? one : psym);
    v[kCv * BP] = (live ? dpsi[p] : T(0)) * gb;
    v[kCl * BP] = (live ? dlap[p] : T(0)) * gb;
  }
}

// Pair bp's Env from the per-pair vectors.
template <typename T, int H>
__device__ __forceinline__ Env<T> tile_env(const T* sV, int bp) {
  constexpr int BP = Tile<H>::BP;
  const T* v = sV + bp;
  Env<T> e;
  e.r1 = v[kR1 * BP];
  e.r2 = v[kR2 * BP];
  e.i1 = v[kI1 * BP];
  e.i2 = v[kI2 * BP];
  e.c12 = v[kC12 * BP];
  e.f1 = v[kF1 * BP];
  e.g1 = v[kG1 * BP];
  e.l1 = v[kL1 * BP];
  e.f2 = v[kF2 * BP];
  e.g2 = v[kG2 * BP];
  e.l2 = v[kL2 * BP];
  return e;
}

// The first layer at the calling thread's pair and units: the 4-stacks
// (s, d1 ga, d1 gb, d1 lz + d2 q) into the rows of A.
template <typename T, int H>
__device__ __forceinline__ void tile_layer1(const T* sw, const Env<T>& e,
                                            T* A) {
  using TL = Tile<H>;
  const int bp = my_pair<H>(), q = my_lane<H>();
#pragma unroll
  for (int i = 0; i < TL::UPT; ++i) {
    const int j = q + TL::TPP * i;
    const Unit1<T> u = unit1<T, H>(sw, j, e);
    A[tile_row<H>(bp, 0) * TL::LD + j] = u.s;
    A[tile_row<H>(bp, 1) * TL::LD + j] = u.d1 * u.ga;
    A[tile_row<H>(bp, 2) * TL::LD + j] = u.d1 * u.gb;
    A[tile_row<H>(bp, 3) * TL::LD + j] = u.d1 * u.lz + u.d2 * u.q;
  }
}

// C = X W2 (TRANS false) or C = X W2^T (TRANS true): X and C are [8P, H]
// tiles, W2 is [H][LD]. Each warp (or, on FMAs, each pair's group of
// lanes) reads only the rows it writes and reads them all before it writes,
// so C may be X. The caller synchronises before (X complete) and after.
template <typename T, int H, bool TRANS>
__device__ __forceinline__ void tile_product(const T* X, const T* W2, T* C) {
  using TL = Tile<H>;
  constexpr int LD = TL::LD;
  if constexpr (use_mma<T, H>()) {
    using namespace nvcuda;
    constexpr int KT = H / 4, CT = H / 8;
    const int warp = threadIdx.x / 32;
    for (int rt = warp; rt < TL::ROWS / 8; rt += kTileWarps) {
      const int r0 = rt * 8;
      wmma::fragment<wmma::matrix_a, 8, 8, 4, double, wmma::row_major> fa[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k)
        wmma::load_matrix_sync(fa[k], X + r0 * LD + 4 * k, LD);
      wmma::fragment<wmma::accumulator, 8, 8, 4, double> acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        wmma::fill_fragment(acc[c], 0.0);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if constexpr (TRANS) {  // B[k][n] = W2[n][k]: W2 read column-major
            wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::col_major>
                fb;
            wmma::load_matrix_sync(fb, W2 + 8 * c * LD + 4 * k, LD);
            wmma::mma_sync(acc[c], fa[k], fb, acc[c]);
          } else {
            wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::row_major>
                fb;
            wmma::load_matrix_sync(fb, W2 + 4 * k * LD + 8 * c, LD);
            wmma::mma_sync(acc[c], fa[k], fb, acc[c]);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < CT; ++c)
        wmma::store_matrix_sync(C + r0 * LD + 8 * c, acc[c], LD,
                                wmma::mem_row_major);
    }
  } else {
    // the calling thread's pair, its units; j outermost so that each
    // loaded value serves 4 or UPT multiply-adds
    const int bp = my_pair<H>(), q = my_lane<H>();
    T acc[4][TL::UPT];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i) acc[c][i] = T(0);
#pragma unroll
    for (int j = 0; j < H; ++j) {
      T wv[TL::UPT];
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i) {
        const int k = q + TL::TPP * i;
        wv[i] = TRANS ? W2[k * LD + j] : W2[j * LD + k];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T xv = X[tile_row<H>(bp, c) * LD + j];
#pragma unroll
        for (int i = 0; i < TL::UPT; ++i) acc[c][i] += xv * wv[i];
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i)
        C[tile_row<H>(bp, c) * LD + q + TL::TPP * i] = acc[c][i];
  }
}

}  // namespace trn
