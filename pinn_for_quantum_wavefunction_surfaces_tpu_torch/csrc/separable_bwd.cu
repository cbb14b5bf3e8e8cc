// K1 backward: cotangents of the fused (psi, lap psi) separable kernel.
//
// Replaces: pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_separable.py
//   bwd_kernel (the pl.pallas_call in fused_bwd), which recomputes _core per
//   (48, 128) tile, applies the tile-local jax.vjp, and writes per-point
//   da, db plus per-tile partials of the 12 weight gradients (summed over
//   tiles outside the kernel); with point_grads=True (:255, :269-272) also
//   dx, dy, dz, dr per point: the PG = true instantiations below.
//
// What bounds it on an H100: arithmetic, about three times the forward's:
// the forward, the MLP adjoints and the weight-gradient sums, 36 H^2 +
// 178 H + 236 operations a point (~12.3k at H = 16; chip_smoke.py,
// bwd_ops) against 80 bytes. Nine of every ten multiply-adds are the H x H
// products: per MLP the second layer L = A W2, its adjoint dA = G W2^T and
// the weight gradient dW2 = A^T G, each 3 H^2 a point. In float64 those
// belong on the tensor cores, and the float64 tanh of the forward's 4 H
// units is the next cost.
//
// Design (separable.cuh): a block of 256 threads walks tiles of P points
// (32 at H = 16), in a fixed order; the grid is at most a fixed multiple of
// the SM count and depends on n alone (the wrapper's grid_blocks). Per tile:
// - the geometry and GZ pair on the block's first P threads, one a point;
// - the forward of both MLPs as in K1-fwd (8 threads a point, tile
//   products on the tensor cores), each MLP into tiles of its own: its
//   first-layer triples A and its second layer's (u, l1, l2) stay in shared
//   memory for the adjoint, so no layer is evaluated twice;
// - the bounded correction, the product rule and their adjoint with the GZ
//   pair's, one thread a point: da, db, and the MLP outputs' cotangents
//   into per-point vectors in shared memory;
// - per MLP: the second layer's cotangent G written over (u, l1, l2);
//   dW2 += A^T G on the tensor cores into accumulators that each warp keeps
//   in registers across the block's tiles (a fixed 8 x 8 tile and K slice
//   of dW2 per warp); dA = G W2^T; the first layer's adjoint per unit. The
//   other weight gradients (w1, b1, b2, ow, ob) are summed over the warp's
//   points by shuffles and added, one owner lane each, into per-warp sums
//   in shared memory.
// At the end each block sums its warps' parts in a fixed order and writes
// ONE row of partial weight gradients; the wrapper sums the rows. No
// atomics, so two launches give the same bits (best-iterate selection in
// L-BFGS compares values across steps). Shared memory: the weights, five
// [3P, H] tiles, the per-warp sums and the per-point vectors, 79 KB in
// float64 at H = 16: 2 blocks of 8 warps an SM, no spills. Lanes past n
// evaluate the finite pad point with zero cotangents, so everything they
// add is exactly 0.
//
// Point gradients (PG = true, a compile-time flag; PG = false is the
// training path and compiles to the same code as before the flag): after
// each MLP's first-layer adjoint the point's lanes sum, in a fixed
// butterfly, the MLP's input cotangents ds = sum_j dz0_j w1[0, j] and
// dcf = sum_j dz0_j w1[1, j] into four more per-point vectors; the tile
// then ends with one per-point phase on the scalar lanes (point_adjoint,
// separable.cuh): the point's geometry, GZ pair and top evaluated again,
// the adjoint of the features, the GZ pair and the explicit R, then the
// geometry's (common.cuh), written to dx, dy, dz, dr for live points only.
// Nothing else changes: the weight gradients keep their order and bits.
// Under the same bound of 2 blocks (128 registers) the float64 PG
// instantiations at H = 4, 8, 16 spill 120-428 B (phase 2 of chip_smoke.py):
// the point phase's scalars on top of the MLP adjoint's.

#include "separable.cuh"

using namespace sep;

namespace {

// per MLP and warp: w1 (2H) | b1 (H) | b2 (H) | ow (H) | ob (1)
template <int H>
__host__ __device__ constexpr int sums_per_mlp() { return 5 * H + 1; }

template <typename T, int H, bool PG>
__host__ __device__ constexpr int smem_elems() {
  return 2 * Tile<H>::WSP + 5 * Tile<H>::ROWS * H +
         kWarps * 2 * sums_per_mlp<H>() +
         (PG ? kPgSlots : kBwdSlots) * Tile<H>::P;
}

// dW2 on the tensor cores: each warp owns FT fixed 8 x 8 tiles of one MLP's
// dW2 and, when there are fewer tiles than warps, one of KS slices of the
// 3P rows.
template <int H>
struct Dw2 {
  // 8 x 8 tiles of dW2 (1 where 8 does not divide H: unused there)
  static constexpr int TO = H % 8 == 0 ? (H / 8) * (H / 8) : 1;
  static constexpr int FT = TO >= kWarps ? TO / kWarps : 1;
  static constexpr int KS = TO >= kWarps ? 1 : kWarps / TO;
  static constexpr int KROWS = Tile<H>::ROWS / KS;
  static_assert(KROWS % 4 == 0, "a K slice holds whole k-steps");
};

// the scalar dW2: each thread owns outputs tid, tid + kThreads, ...
template <int H>
__host__ __device__ constexpr int scalar_dw2_per_thread() {
  return (H * H + kThreads - 1) / kThreads;
}

template <typename T, int H, bool PG>
__global__ void __launch_bounds__(kThreads, H > 16 ? 1 : 2)
    separable_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ z, const T* __restrict__ r,
                         const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ w, const T* __restrict__ dpsi,
                         const T* __restrict__ dlap, T* __restrict__ da_out,
                         T* __restrict__ db_out, T* __restrict__ partials,
                         T* __restrict__ dx_out, T* __restrict__ dy_out,
                         T* __restrict__ dz_out, T* __restrict__ dr_out,
                         int n, T psym, T ry, T rz) {
  using TL = Tile<H>;
  using L = Layout<H>;
  constexpr int WS = L::SIZE;
  constexpr int NS = sums_per_mlp<H>();
  constexpr int TS = TL::ROWS * H;  // values of a [3P, H] tile
  constexpr bool MMA = use_mma<T, H>();
  using namespace nvcuda;
  using Acc = wmma::fragment<wmma::accumulator, 8, 8, 4, double>;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sX = sw + 2 * TL::WSP;   // [mlp][3P][H] first-layer triples A
  T* sY = sX + 2 * TS;        // [mlp][3P][H] (u, l1, l2), then G
  T* sZ = sY + 2 * TS;        // [3P][H] dA
  T* sS = sZ + TS;            // [warp][mlp][NS] sums
  T* sV = sS + kWarps * 2 * NS;  // [slot][P] per-point vectors
  load_weights<T, H>(w, sw);
  for (int i = threadIdx.x; i < kWarps * 2 * NS; i += kThreads) sS[i] = T(0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lp = threadIdx.x / TL::TPP, q = threadIdx.x % TL::TPP;
  const int u0 = unit0<H>();
  const bool scalar = threadIdx.x < TL::P;  // whole warps (Tile)

  // dW2 accumulators, kept across the tiles
  Acc dacc[2][Dw2<H>::FT];
  T sacc[2][scalar_dw2_per_thread<H>()];
  if constexpr (MMA) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int f = 0; f < Dw2<H>::FT; ++f) wmma::fill_fragment(dacc[m][f], 0.0);
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int o = 0; o < scalar_dw2_per_thread<H>(); ++o) sacc[m][o] = T(0);
  }

  const int tiles = (n + TL::P - 1) / TL::P;
  const T one = T(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the scalar lanes: geometry and GZ pair of point threadIdx.x
    const int p = tile * TL::P + threadIdx.x;
    const bool live = scalar && p < n;
    const T av = live ? a[p] : one;
    const T bv = live ? b[p] : one;
    Point<T> pt;
    GZ<T> g;
    if (scalar) {
      point_gz(live ? x[p] : one, live ? y[p] : one, live ? z[p] : one,
               live ? r[p] : one, ry, rz, av, bv, psym, pt, g);
      sV[kT0 * TL::P + threadIdx.x] = pt.t0;
      sV[kE0 * TL::P + threadIdx.x] = pt.e0;
      sV[kCf * TL::P + threadIdx.x] = pt.cf;
    }
    __syncthreads();
    // the MLPs' forward, TPP lanes a point, each MLP into its own tiles
    // (the inputs kept in registers: the scalar lanes overwrite their slots
    // for the next tile while the other warps finish this one)
    const T st = sV[kT0 * TL::P + lp], se = sV[kE0 * TL::P + lp];
    const T cf = sV[kCf * TL::P + lp];
    T o[6];
    mlp_tile_forward<T, H>(sw, st, cf, sX, sY, o[0], o[1], o[2]);
    mlp_tile_forward<T, H>(sw + TL::WSP, se, cf, sX + TS, sY + TS, o[3], o[4],
                           o[5]);
    if (q == 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) sV[(kL0 + c) * TL::P + lp] = o[c];
    }
    __syncthreads();
    // the scalar lanes: the top, its adjoint and the GZ pair's
    if (scalar) {
      T* v = sV + threadIdx.x;
      const T l1 = v[kL1 * TL::P], m1 = v[kM1 * TL::P];
      Top<T> top;
      top_forward(v[kL0 * TL::P], l1, v[kL2 * TL::P], v[kM0 * TL::P], m1,
                  v[kM2 * TL::P], g, pt, top);
      const TopGrad<T> tg =
          top_adjoint(av, bv, l1, m1, live ? dpsi[p] : T(0),
                      live ? dlap[p] : T(0), g, pt, top);
      if (live) {
        da_out[p] = tg.da;
        db_out[p] = tg.db;
      }
      v[kDq0 * TL::P] = tg.dq0;
      v[kDl1 * TL::P] = tg.dl1;
      v[kDl2 * TL::P] = tg.dl2;
      v[kDm1 * TL::P] = tg.dm1;
      v[kDm2 * TL::P] = tg.dm2;
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const T* W = sw + m * TL::WSP;
      T* X = sX + m * TS;
      T* Y = sY + m * TS;
      T* sums = sS + (warp * 2 + m) * NS;
      const T d0 = sV[kDq0 * TL::P + lp];
      const T d1 = sV[(m == 0 ? kDl1 : kDm1) * TL::P + lp];
      const T d2 = sV[(m == 0 ? kDl2 : kDm2) * TL::P + lp];
      // the second layer's cotangent G over (u, l1, l2), own elements
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i) {
        const int k = u0 + i;
        T* yk = Y + lp * H + k;
        const T u = yk[0], ll1 = yk[TL::P * H], ll2 = yk[2 * TL::P * H];
        const T gg = T(1) - u * u;
        const T hh = T(-2) * u * gg;
        const T owk = W[L::OW + k];
        const T cow = u * d0 + (gg * ll1) * d1 + (gg * ll2 + hh * ll1 * ll1) * d2;
        const T db0 = d0 * owk, db1 = d1 * owk, db2 = d2 * owk;
        const T dlin1 = db1 * gg + db2 * T(2) * hh * ll1;
        const T dlin2 = db2 * gg;
        T dgg = db1 * ll1 + db2 * ll2;
        const T dhh = db2 * ll1 * ll1;
        T du = db0 - T(2) * gg * dhh;
        dgg = dgg - T(2) * u * dhh;
        du = du - T(2) * u * dgg;
        const T dlin0 = du * gg;
        yk[0] = dlin0;
        yk[TL::P * H] = dlin1;
        yk[2 * TL::P * H] = dlin2;
        const T c3 = warp_points_sum<H>(dlin0);
        const T c4 = warp_points_sum<H>(cow);
        if (lane < TL::TPP) {  // the warp's first point's lanes own the sums
          sums[3 * H + k] += c3;
          sums[4 * H + k] += c4;
        }
      }
      __syncthreads();
      // dW2 += A^T G, and dA = G W2^T (both read A and G only)
      if constexpr (MMA) {
#pragma unroll
        for (int f = 0; f < Dw2<H>::FT; ++f) {
          const int tt = Dw2<H>::KS == 1 ? warp + kWarps * f : warp % Dw2<H>::TO;
          const int ks = Dw2<H>::KS == 1 ? 0 : warp / Dw2<H>::TO;
          const int i0 = (tt / (H / 8)) * 8, k0 = (tt % (H / 8)) * 8;
#pragma unroll 4
          for (int r0 = ks * Dw2<H>::KROWS; r0 < (ks + 1) * Dw2<H>::KROWS;
               r0 += 4) {
            // A^T (i, r) = X[r][i]: X read column-major
            wmma::fragment<wmma::matrix_a, 8, 8, 4, double, wmma::col_major> fa;
            wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, X + r0 * H + i0, H);
            wmma::load_matrix_sync(fb, Y + r0 * H + k0, H);
            wmma::mma_sync(dacc[m][f], fa, fb, dacc[m][f]);
          }
        }
      } else {
#pragma unroll
        for (int o = 0; o < scalar_dw2_per_thread<H>(); ++o) {
          const int e = threadIdx.x + kThreads * o;
          if (e < H * H) {
            const int i = e / H, k = e % H;
            T acc = sacc[m][o];
            for (int row = 0; row < TL::ROWS; ++row)
              acc += X[row * H + i] * Y[row * H + k];
            sacc[m][o] = acc;
          }
        }
      }
      tile_product<T, H, true>(Y, W + L::W2, sZ);
      __syncthreads();
      // the first layer's adjoint at the thread's units, seed (z0, w, 0)
      const T s = m == 0 ? st : se;
      T ds = T(0), dc = T(0);  // PG: the MLP's input cotangents (s, cf)
#pragma unroll
      for (int i = 0; i < TL::UPT; ++i) {
        const int j = u0 + i;
        const T da0 = sZ[lp * H + j];
        const T da1 = sZ[(TL::P + lp) * H + j];
        const T da2 = sZ[(2 * TL::P + lp) * H + j];
        const T wj = W[L::W1 + j];
        const T t = X[lp * H + j];
        const T gt = T(1) - t * t;
        const T ht = T(-2) * t * gt;
        const T dz1 = da1 * gt + da2 * T(2) * ht * wj;
        T dg = da1 * wj;
        const T dh = da2 * wj * wj;
        T dt = da0 - T(2) * gt * dh;
        dg = dg - T(2) * t * dh;
        dt = dt - T(2) * t * dg;
        const T dz0 = dt * gt;
        if constexpr (PG) {
          ds += dz0 * wj;
          dc += dz0 * W[L::W1 + H + j];
        }
        const T c0 = warp_points_sum<H>(s * dz0 + dz1);
        const T c1 = warp_points_sum<H>(cf * dz0);
        const T c2 = warp_points_sum<H>(dz0);
        if (lane < TL::TPP) {
          sums[j] += c0;
          sums[H + j] += c1;
          sums[2 * H + j] += c2;
        }
      }
      const T cob = warp_points_sum<H>(d0);
      if (lane == 0) sums[5 * H] += cob;
      if constexpr (PG) {
        ds = point_sum<H>(ds);
        dc = point_sum<H>(dc);
        if (q == 0) {
          sV[(kDsL + m) * TL::P + lp] = ds;
          sV[(kDcfL + m) * TL::P + lp] = dc;
        }
      }
    }
    if constexpr (PG) {
      // the scalar lanes: the point gradient of each live point
      __syncthreads();
      if (live) {
        const T* v = sV + threadIdx.x;
        T gx, gy, gz, gr;
        point_adjoint(x[p], y[p], z[p], r[p], ry, rz, a[p], b[p], psym,
                      v[kL0 * TL::P], v[kL1 * TL::P], v[kL2 * TL::P],
                      v[kM0 * TL::P], v[kM1 * TL::P], v[kM2 * TL::P], dpsi[p],
                      dlap[p], v[kDsL * TL::P], v[kDsM * TL::P],
                      v[kDcfL * TL::P] + v[kDcfM * TL::P], gx, gy, gz, gr);
        dx_out[p] = gx;
        dy_out[p] = gy;
        dz_out[p] = gz;
        dr_out[p] = gr;
      }
    }
  }

  // the block's row of partial weight gradients, summed in a fixed order
  __syncthreads();
  T* part = partials + static_cast<size_t>(blockIdx.x) * 2 * WS;
  for (int o = threadIdx.x; o < 2 * NS; o += kThreads) {
    const int m = o / NS, e = o % NS;
    T acc = T(0);
    for (int v = 0; v < kWarps; ++v) acc += sS[(v * 2 + m) * NS + e];
    const int dst = e < 3 * H   ? e                        // w1, b1
                    : e < 4 * H ? L::B2 + (e - 3 * H)      // b2
                    : e < 5 * H ? L::OW + (e - 4 * H)      // ow
                                : L::OB;                   // ob
    part[m * WS + dst] = acc;
  }
  if constexpr (MMA) {
    // stage the warps' dW2 tiles in [mlp][K slice][H][H] over the A tiles
    T* stage = sX;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int f = 0; f < Dw2<H>::FT; ++f) {
        const int tt = Dw2<H>::KS == 1 ? warp + kWarps * f : warp % Dw2<H>::TO;
        const int ks = Dw2<H>::KS == 1 ? 0 : warp / Dw2<H>::TO;
        const int i0 = (tt / (H / 8)) * 8, k0 = (tt % (H / 8)) * 8;
        wmma::store_matrix_sync(stage + ((m * Dw2<H>::KS + ks) * H + i0) * H + k0,
                                dacc[m][f], H, wmma::mem_row_major);
      }
    __syncthreads();
    for (int o = threadIdx.x; o < 2 * H * H; o += kThreads) {
      const int m = o / (H * H), e = o % (H * H);
      T acc = T(0);
      for (int ks = 0; ks < Dw2<H>::KS; ++ks)
        acc += stage[(m * Dw2<H>::KS + ks) * H * H + e];
      part[m * WS + L::W2 + e] = acc;
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int o = 0; o < scalar_dw2_per_thread<H>(); ++o) {
        const int e = threadIdx.x + kThreads * o;
        if (e < H * H) part[m * WS + L::W2 + e] = sacc[m][o];
      }
  }
}

template <typename T, int H, bool PG>
cudaError_t prepare(size_t* smem) {
  static_assert(2 * Dw2<H>::KS * H * H <= 2 * Tile<H>::ROWS * H,
                "the dW2 staging fits the two tiles");
  *smem = sizeof(T) * smem_elems<T, H, PG>();
  return cudaFuncSetAttribute(separable_bwd_kernel<T, H, PG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T, int H, bool PG>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* w,
                   const void* dpsi, const void* dlap, void* da, void* db,
                   void* partials, void* dx, void* dy, void* dz, void* dr,
                   int n, int psym, int grid, double ry, double rz,
                   cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare<T, H, PG>(&smem);
  if (err != cudaSuccess) return err;
  separable_bwd_kernel<T, H, PG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(w), static_cast<const T*>(dpsi),
      static_cast<const T*>(dlap), static_cast<T*>(da), static_cast<T*>(db),
      static_cast<T*>(partials), static_cast<T*>(dx), static_cast<T*>(dy),
      static_cast<T*>(dz), static_cast<T*>(dr), n, T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

template <typename T, int H, bool PG>
int occupancy(int* smem_bytes) {
  size_t smem;
  if (prepare<T, H, PG>(&smem) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, separable_bwd_kernel<T, H, PG>, kThreads, smem) !=
      cudaSuccess)
    return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

template <typename T>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* w, const void* dpsi,
             const void* dlap, void* da, void* db, void* partials, void* dx,
             void* dy, void* dz, void* dr, int n, int hidden, int psym,
             int grid, int pg, double ry, double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pg && (!dx || !dy || !dz || !dr))
    return static_cast<int>(cudaErrorInvalidValue);
#define SEP_BWD_CASE(HH)                                                     \
  case HH:                                                                   \
    return pg ? launch<T, HH, true>(x, y, z, r, a, b, w, dpsi, dlap, da, db, \
                                    partials, dx, dy, dz, dr, n, psym, grid, \
                                    ry, rz, s)                               \
              : launch<T, HH, false>(x, y, z, r, a, b, w, dpsi, dlap, da,    \
                                     db, partials, dx, dy, dz, dr, n, psym,  \
                                     grid, ry, rz, s);
  switch (hidden) {
    SEP_BWD_CASE(4)
    SEP_BWD_CASE(8)
    SEP_BWD_CASE(16)
    SEP_BWD_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SEP_BWD_CASE
}

// Resident blocks per SM of the f64 (f64 != 0) or f32 instantiation at this
// width (PG: its point-gradient instantiation), and its shared memory per
// block in *smem_bytes; -1 on error.
template <bool PG>
int occupancy_at(int hidden, int f64, int* smem_bytes) {
#define SEP_BWD_OCC(HH)                                   \
  case HH:                                                \
    return f64 ? occupancy<double, HH, PG>(smem_bytes)    \
               : occupancy<float, HH, PG>(smem_bytes);
  switch (hidden) {
    SEP_BWD_OCC(4)
    SEP_BWD_OCC(8)
    SEP_BWD_OCC(16)
    SEP_BWD_OCC(32)
    default:
      return -1;
  }
#undef SEP_BWD_OCC
}

}  // namespace

// dx, dy, dz, dr: the point gradients, written when pg != 0 (the PG = true
// instantiations); null otherwise.
extern "C" int separable_bwd_f64(const void* x, const void* y, const void* z,
                                 const void* r, const void* a, const void* b,
                                 const void* w, const void* dpsi,
                                 const void* dlap, void* da, void* db,
                                 void* partials, void* dx, void* dy, void* dz,
                                 void* dr, int n, int hidden, int psym,
                                 int grid, int pg, double ry, double rz,
                                 void* stream) {
  return dispatch<double>(x, y, z, r, a, b, w, dpsi, dlap, da, db, partials,
                          dx, dy, dz, dr, n, hidden, psym, grid, pg, ry, rz,
                          stream);
}

extern "C" int separable_bwd_f32(const void* x, const void* y, const void* z,
                                 const void* r, const void* a, const void* b,
                                 const void* w, const void* dpsi,
                                 const void* dlap, void* da, void* db,
                                 void* partials, void* dx, void* dy, void* dz,
                                 void* dr, int n, int hidden, int psym,
                                 int grid, int pg, double ry, double rz,
                                 void* stream) {
  return dispatch<float>(x, y, z, r, a, b, w, dpsi, dlap, da, db, partials, dx,
                         dy, dz, dr, n, hidden, psym, grid, pg, ry, rz,
                         stream);
}

// Points a tile at this width, the same in both types (the wrapper's
// grid_blocks must agree), or -1.
extern "C" int separable_bwd_points_per_tile(int hidden, int /*f64*/) {
  switch (hidden) {
    case 4: return Tile<4>::P;
    case 8: return Tile<8>::P;
    case 16: return Tile<16>::P;
    case 32: return Tile<32>::P;
    default: return -1;
  }
}

extern "C" int separable_bwd_occupancy(int hidden, int f64, int* smem_bytes) {
  return occupancy_at<false>(hidden, f64, smem_bytes);
}

extern "C" int separable_bwd_pg_occupancy(int hidden, int f64,
                                          int* smem_bytes) {
  return occupancy_at<true>(hidden, f64, smem_bytes);
}

extern "C" const char* separable_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
