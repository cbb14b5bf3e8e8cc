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
// The sums over points (the weight gradients) run in a FIXED order with no
// atomics, so two launches give the same bits (best-iterate selection in
// L-BFGS compares values across steps): a block walks the tiles blockIdx,
// blockIdx + grid, ... of a grid fixed by n, H and the type alone (the
// wrapper's grid_blocks: the resident blocks an SM, 2 in float64 and 3 in
// float32 and bfloat16, times 132 SMs), keeps its sums across its tiles
// and writes ONE row of partial weight gradients at the end; the wrapper
// sums the rows. Lanes past n evaluate the finite pad point with zero
// cotangents, so everything they add is exactly 0.
//
// Design, by type (separable.cuh):
// - float64 (separable_bwd_kernel): a block of 256 threads walks tiles of
//   P points (32 at H = 16). Per tile: the geometry and GZ pair on the
//   block's first P threads, one a point; the forward of both MLPs as in
//   K1-fwd (8 threads a point, tile products on the tensor cores), each
//   MLP into tiles of its own: its first-layer triples A and its second
//   layer's (u, l1, l2) stay in shared memory for the adjoint, so no layer
//   is evaluated twice; the bounded correction, the product rule and their
//   adjoint with the GZ pair's, one thread a point: da, db, and the MLP
//   outputs' cotangents into per-point vectors in shared memory; per MLP
//   the second layer's cotangent G written over (u, l1, l2), dW2 += A^T G
//   on the tensor cores into accumulators that each warp keeps in
//   registers across the block's tiles (a fixed 8 x 8 tile and K slice of
//   dW2 per warp), dA = G W2^T, and the first layer's adjoint per unit. The
//   other weight gradients (w1, b1, b2, ow, ob) are summed over the warp's
//   points by shuffles and added, one owner lane each, into per-warp sums
//   in shared memory. Shared memory: the weights, five [3P, H] tiles, the
//   per-warp sums and the per-point vectors, 79 KB at H = 16: 2 blocks of
//   8 warps an SM, no spills.
// - float32 (separable_bwd_point_kernel): one thread a point, 128 points a
//   block, two barriers a tile. The point's thread computes its geometry,
//   GZ pair and both MLPs' forward (mlp_point_forward), writing each MLP's
//   first-layer t to its row of a shared [128, 2H + 4] buffer and the
//   second layer's (u, l1, l2) to its row of a [128, 6H + 4] one (the
//   padding puts a warp's 16-byte row accesses on distinct banks); then
//   the top's adjoint, da and db, and per MLP the cotangent G written over
//   (u, l1, l2), dA = G W2^T from its own row (each 16-byte read of
//   w2[j][k..k+3] serves three components, so W2 is read row-wise and the
//   transposed bank conflict of a column read never arises) and the first
//   layer's adjoint. After a barrier, dW2 += A^T G is a register-blocked
//   product: each thread owns a 4 x 4 block of one MLP's dW2 over a fixed
//   slice of the tile's points, forms A's triples (t, g w, h w^2) at its
//   four units from t as the forward does (storing t alone, not the
//   triples, lets 3 blocks share an SM instead of 2, which measured faster
//   at every size), reads G's three rows with 16-byte shared loads,
//   and keeps the block across its tiles; the owners of b2's units add G's
//   first component beside it. The other small leaves (w1, b1, ow, ob) go
//   through fixed shuffle trees (common.cuh add_warp_sums) into per-warp
//   sums. 163 registers and 74 KB of shared memory at H = 16: 3 blocks of
//   4 warps an SM, no spills. Measured on an H100 SXM at 700 W
//   (chip_smoke.py --k1-times): 2.4x its operation bound at 1 048 576
//   points, 3.0x at 164 502. What bounds it: the issue rate of the
//   products' FMAs and shared loads, and the leaf sums' shuffle trees,
//   whose latency 12 warps an SM hide poorly (a variant that skipped the
//   sums ran markedly faster; moving b2's sum into the register-blocked
//   product above took one fifth of them away).
// - bfloat16 (separable_bwd_bf16): the float32 kernel on bfloat16 tensors.
//   Points, heads, weights and cotangents are loaded into float; da, db
//   and the point gradients are rounded once to bfloat16 as they are
//   stored; the rows of partial weight gradients stay float32 (the wrapper
//   sums them in float32 in their fixed order and rounds the sums once), so
//   two launches still agree bit for bit.
//
// Point gradients (PG = true, a compile-time flag; PG = false is the
// training path): the MLPs' input cotangents ds = sum_j dz0_j w1[0, j] and
// dcf = sum_j dz0_j w1[1, j] are summed with the first layer's adjoint;
// then the point's geometry, GZ pair and top are evaluated again from its
// inputs, and the adjoint of the features, the GZ pair and the explicit R,
// then the geometry's (point_adjoint, separable.cuh; common.cuh), is
// written to dx, dy, dz, dr for live points only. Float64 sums ds and dcf
// over a point's lanes in a fixed butterfly into per-point vectors and
// runs the point phase on the scalar lanes; under its bound of 2 blocks
// (128 registers) its PG instantiations at H = 4, 8, 16 spill 120-428 B
// (phase 2 of chip_smoke.py). The float32 thread does it in registers. In
// both, the weight gradients, da and db keep the bits of PG = false.
//
// Excited states (EX = true; exclusive with PG): the top's adjoint becomes
// the factor epilogue's (separable.cuh ex_adjoint), which hands the top's
// own adjoint its cotangents and adds those of the top's gradient; the
// node heads' cotangents dc1, dc2, dn0 are written per point beside da and
// db (autograd sums them over each row into the heads). The MLP adjoints
// and the weight-gradient sums are the ground kernel's.

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

// The float64 build (S = T = double): tiles of P points on the tensor
// cores. EX: the adjoint of the excited-state factor epilogue
// (separable.cuh ex_adjoint) in the top's, its nodes' cotangents written
// beside da and db.
template <typename S, int H, bool PG, bool EX,
          typename T = kern::compute_t<S>>
__global__ void __launch_bounds__(kThreads, H > 16 ? 1 : 2)
    separable_bwd_kernel(const S* __restrict__ x, const S* __restrict__ y,
                         const S* __restrict__ z, const S* __restrict__ r,
                         const S* __restrict__ a, const S* __restrict__ b,
                         const S* __restrict__ c1, const S* __restrict__ c2,
                         const S* __restrict__ n0, const S* __restrict__ w,
                         const S* __restrict__ dpsi,
                         const S* __restrict__ dlap, S* __restrict__ da_out,
                         S* __restrict__ db_out, S* __restrict__ dc1_out,
                         S* __restrict__ dc2_out, S* __restrict__ dn0_out,
                         T* __restrict__ partials, S* __restrict__ dx_out,
                         S* __restrict__ dy_out, S* __restrict__ dz_out,
                         S* __restrict__ dr_out, int n, T psym, T ry, T rz,
                         int code) {
  using kern::ld;
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
    const T av = live ? ld(a[p]) : one;
    const T bv = live ? ld(b[p]) : one;
    Point<T> pt;
    GZ<T> g;
    if (scalar) {
      point_gz(live ? ld(x[p]) : one, live ? ld(y[p]) : one,
               live ? ld(z[p]) : one, live ? ld(r[p]) : one, ry, rz, av, bv,
               psym, pt, g);
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
      TopGrad<T> tg;
      if constexpr (EX) {
        const Factors fc = factors_of(code);
        T v1, v2, v0;
        load_nodes(fc, live, p, c1, c2, n0, v1, v2, v0);
        Ex<T> ex;
        ex_forward(fc, live ? ld(y[p]) : one, live ? ld(z[p]) : one,
                   live ? ld(r[p]) : one, ry, rz, v1, v2, v0, l1, m1, g, pt,
                   top, ex);
        T dc1, dc2, dn0;
        tg = ex_adjoint(fc, av, bv, l1, m1, live ? ld(dpsi[p]) : T(0),
                        live ? ld(dlap[p]) : T(0), g, pt, top, ex, dc1, dc2,
                        dn0);
        if (live) {
          if (fc.rad > 0) dc1_out[p] = kern::st<S>(dc1);
          if (fc.rad > 1) dc2_out[p] = kern::st<S>(dc2);
          if (fc.ang) dn0_out[p] = kern::st<S>(dn0);
        }
      } else {
        tg = top_adjoint(av, bv, l1, m1, live ? ld(dpsi[p]) : T(0),
                         live ? ld(dlap[p]) : T(0), g, pt, top);
      }
      if (live) {
        da_out[p] = kern::st<S>(tg.da);
        db_out[p] = kern::st<S>(tg.db);
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
        point_adjoint(ld(x[p]), ld(y[p]), ld(z[p]), ld(r[p]), ry, rz,
                      ld(a[p]), ld(b[p]), psym, v[kL0 * TL::P],
                      v[kL1 * TL::P], v[kL2 * TL::P], v[kM0 * TL::P],
                      v[kM1 * TL::P], v[kM2 * TL::P], ld(dpsi[p]),
                      ld(dlap[p]), v[kDsL * TL::P], v[kDsM * TL::P],
                      v[kDcfL * TL::P] + v[kDcfM * TL::P], gx, gy, gz, gr);
        dx_out[p] = kern::st<S>(gx);
        dy_out[p] = kern::st<S>(gy);
        dz_out[p] = kern::st<S>(gz);
        dr_out[p] = kern::st<S>(gr);
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

// ---------------------------------------------------------------------------
// float32 (and bfloat16 in float): one thread a point, register-blocked dW2

template <int H>
struct PointTile {
  static constexpr int P = kPointThreads;        // points (threads) a block
  static constexpr int WARPS = P / 32;
  static constexpr int PA = 2 * H + 4;           // a point's row of t
  static constexpr int PS = 6 * H + 4;           // its row of Y / G
  static constexpr int NB = (H / 4) * (H / 4);   // 4 x 4 blocks of one dW2
  static constexpr int NO = 2 * NB;              // (MLP, block) owners
  static constexpr int NSL = P / NO;             // slices of the P points
  static constexpr int NS = 4 * H + 1;           // a warp's sums of an MLP
  static_assert(NSL * NO == P, "every thread owns a block and a slice");
  static_assert(2 * NSL * (H * H + H) <= P * PS,
                "the dW2 and b2 staging fits G");
};

// Shared memory of the point kernel: the weights [2][WSP], the points'
// first-layer t [P][PA] and their Y, then G [P][PS], the warps' per-unit
// sums [warp][2][NS]: w1 (2H) | b1 (H) | ow (H) | ob (1).
template <int H>
constexpr int point_smem_elems() {
  using PT = PointTile<H>;
  return 2 * Tile<H>::WSP + PT::P * (PT::PA + PT::PS) +
         PT::WARPS * 2 * PT::NS;
}

// S: the tensors' storage type (float or __nv_bfloat16); the arithmetic and
// the partials are float's.
template <typename S, int H, bool PG, bool EX>
__global__ void __launch_bounds__(kPointThreads, H > 16 ? 1 : 3)
    separable_bwd_point_kernel(
        const S* __restrict__ x, const S* __restrict__ y,
        const S* __restrict__ z, const S* __restrict__ r,
        const S* __restrict__ a, const S* __restrict__ b,
        const S* __restrict__ c1, const S* __restrict__ c2,
        const S* __restrict__ n0, const S* __restrict__ w,
        const S* __restrict__ dpsi, const S* __restrict__ dlap,
        S* __restrict__ da_out, S* __restrict__ db_out,
        S* __restrict__ dc1_out, S* __restrict__ dc2_out,
        S* __restrict__ dn0_out, float* __restrict__ partials,
        S* __restrict__ dx_out, S* __restrict__ dy_out,
        S* __restrict__ dz_out, S* __restrict__ dr_out, int n, float psym,
        float ry, float rz, int code) {
  using kern::add_warp_sums;
  using kern::ld;
  using kern::load4;
  using kern::store4;
  using PT = PointTile<H>;
  using L = Layout<H>;
  constexpr int P = PT::P, PA = PT::PA, PS = PT::PS, WS = L::SIZE;
  constexpr int WSP = Tile<H>::WSP, NS = PT::NS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sw = reinterpret_cast<float*>(smem_raw);
  float* sA = sw + 2 * WSP;  // [P][PA] first-layer t, MLP m at m H
  float* sG = sA + P * PA;   // [P][PS] (u, l1, l2), then their cotangents G
  float* sS = sG + P * PS;   // [warp][mlp][NS] per-unit sums
  load_weights<float, H, kPointThreads>(w, sw);
  for (int i = threadIdx.x; i < PT::WARPS * 2 * NS; i += P) sS[i] = 0.0f;
  __syncthreads();

  const int tid = threadIdx.x, lane = tid % 32;
  float* sums = sS + (tid / 32) * 2 * NS;
  float* rowA = sA + tid * PA;
  float* rowG = sG + tid * PS;
  // the thread's 4 x 4 block (bi, bk) of MLP om's dW2 and its slice sl of
  // the tile's points
  const int own = tid % PT::NO, sl = tid / PT::NO;
  const int om = own / PT::NB;
  const int bi = (own % PT::NB) / (H / 4), bk = (own % PT::NB) % (H / 4);
  float w0[4];  // w1[0, 4 bi .. 4 bi + 3] of MLP om
  load4(sw + om * WSP + L::W1 + 4 * bi, w0);
  float dw[4][4], db2[4];  // db2: its four units of b2, where bi = 0
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    db2[u] = 0.0f;
#pragma unroll
    for (int v = 0; v < 4; ++v) dw[u][v] = 0.0f;
  }

  const int tiles = (n + P - 1) / P;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p = tile * P + tid;
    const bool live = p < n;
    const float av = live ? ld(a[p]) : 1.0f;
    const float bv = live ? ld(b[p]) : 1.0f;
    Point<float> pt;
    GZ<float> g;
    point_gz(live ? ld(x[p]) : 1.0f, live ? ld(y[p]) : 1.0f,
             live ? ld(z[p]) : 1.0f, live ? ld(r[p]) : 1.0f, ry, rz, av, bv,
             psym, pt, g);
    // the MLPs' forward, their first-layer t and (u, l1, l2) to shared
    // memory
    float o[6];
    mlp_point_forward<H, true>(sw, pt.t0, pt.cf, rowA, rowG, o[0], o[1],
                               o[2]);
    mlp_point_forward<H, true>(sw + WSP, pt.e0, pt.cf, rowA + H,
                               rowG + 3 * H, o[3], o[4], o[5]);
    // the top, its adjoint and the GZ pair's
    Top<float> top;
    top_forward(o[0], o[1], o[2], o[3], o[4], o[5], g, pt, top);
    const float gpsi = live ? ld(dpsi[p]) : 0.0f;
    const float glap = live ? ld(dlap[p]) : 0.0f;
    TopGrad<float> tg;
    if constexpr (EX) {
      const Factors fc = factors_of(code);
      float v1, v2, v0;
      load_nodes(fc, live, p, c1, c2, n0, v1, v2, v0);
      Ex<float> ex;
      ex_forward(fc, live ? ld(y[p]) : 1.0f, live ? ld(z[p]) : 1.0f,
                 live ? ld(r[p]) : 1.0f, ry, rz, v1, v2, v0, o[1], o[4], g,
                 pt, top, ex);
      float dc1, dc2, dn0;
      tg = ex_adjoint(fc, av, bv, o[1], o[4], gpsi, glap, g, pt, top, ex,
                      dc1, dc2, dn0);
      if (live) {
        if (fc.rad > 0) dc1_out[p] = kern::st<S>(dc1);
        if (fc.rad > 1) dc2_out[p] = kern::st<S>(dc2);
        if (fc.ang) dn0_out[p] = kern::st<S>(dn0);
      }
    } else {
      tg = top_adjoint(av, bv, o[1], o[4], gpsi, glap, g, pt, top);
    }
    if (live) {
      da_out[p] = kern::st<S>(tg.da);
      db_out[p] = kern::st<S>(tg.db);
    }
    {  // ob: both MLPs' output bias takes dq0
      float c1[1] = {tg.dq0};
      kern::warp_unit_sum<1, 1>(c1, lane);
      if (lane == 0) {
        sums[4 * H] += c1[0];
        sums[NS + 4 * H] += c1[0];
      }
    }
    float ds[2], dc = 0.0f;  // PG: the MLPs' input cotangents (s, cf)
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      const float* W = sw + m * WSP;
      float* A = rowA + m * H;
      float* G = rowG + 3 * m * H;
      float* msums = sums + m * NS;
      const float d0 = tg.dq0;
      const float d1 = m == 0 ? tg.dl1 : tg.dm1;
      const float d2 = m == 0 ? tg.dl2 : tg.dm2;
      // the second layer's cotangent G over (u, l1, l2), four units at a
      // time, with the ow terms (b2's is G's first component: summed in
      // the dW2 pass below)
#pragma unroll 2
      for (int k0 = 0; k0 < H; k0 += 4) {
        float u[4], ll1[4], ll2[4], owk[4], cow[4];
        load4(G + k0, u);
        load4(G + H + k0, ll1);
        load4(G + 2 * H + k0, ll2);
        load4(W + L::OW + k0, owk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gg = 1.0f - u[i] * u[i];
          const float hh = -2.0f * u[i] * gg;
          cow[i] = u[i] * d0 + (gg * ll1[i]) * d1 +
                   (gg * ll2[i] + hh * ll1[i] * ll1[i]) * d2;
          const float db0 = d0 * owk[i], db1 = d1 * owk[i];
          const float db2 = d2 * owk[i];
          const float dlin1 = db1 * gg + db2 * 2.0f * hh * ll1[i];
          const float dlin2 = db2 * gg;
          float dgg = db1 * ll1[i] + db2 * ll2[i];
          const float dhh = db2 * ll1[i] * ll1[i];
          float du = db0 - 2.0f * gg * dhh;
          dgg = dgg - 2.0f * u[i] * dhh;
          du = du - 2.0f * u[i] * dgg;
          u[i] = du * gg;  // dlin0
          ll1[i] = dlin1;
          ll2[i] = dlin2;
        }
        store4(G + k0, u);
        store4(G + H + k0, ll1);
        store4(G + 2 * H + k0, ll2);
        add_warp_sums<4>(cow, msums + 3 * H + k0, lane);
      }
      // dA = G W2^T from the point's row G, four units at a time (each
      // read of w2[j][k..k+3] serves three components), then the first
      // layer's adjoint at those units, seed (s, 1, 0)
      const float s = m == 0 ? pt.t0 : pt.e0;
      float dsm = 0.0f;
#pragma unroll 2
      for (int j0 = 0; j0 < H; j0 += 4) {
        float dac[3][4];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dac[c][jj] = 0.0f;
#pragma unroll
        for (int k0 = 0; k0 < H; k0 += 4) {
          float gk[3][4];
#pragma unroll
          for (int c = 0; c < 3; ++c) load4(G + c * H + k0, gk[c]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float wv[4];
            load4(W + L::W2 + (j0 + jj) * H + k0, wv);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int c = 0; c < 3; ++c) dac[c][jj] += gk[c][kk] * wv[kk];
          }
        }
        float t4[4], t0[4], t1[4], t2[4];
        load4(A + j0, t4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj;
          const float wj = W[L::W1 + j];
          const float t = t4[jj];
          const float gt = 1.0f - t * t;
          const float ht = -2.0f * t * gt;
          const float dz1 = dac[1][jj] * gt + dac[2][jj] * 2.0f * ht * wj;
          float dg = dac[1][jj] * wj;
          const float dh = dac[2][jj] * wj * wj;
          float dt = dac[0][jj] - 2.0f * gt * dh;
          dg = dg - 2.0f * t * dh;
          dt = dt - 2.0f * t * dg;
          const float dz0 = dt * gt;
          if constexpr (PG) {
            dsm += dz0 * wj;
            dc += dz0 * W[L::W1 + H + j];
          }
          t0[jj] = s * dz0 + dz1;
          t1[jj] = pt.cf * dz0;
          t2[jj] = dz0;
        }
        add_warp_sums<4>(t0, msums + j0, lane);
        add_warp_sums<4>(t1, msums + H + j0, lane);
        add_warp_sums<4>(t2, msums + 2 * H + j0, lane);
      }
      if (m == 0)
        ds[0] = dsm;
      else
        ds[1] = dsm;
    }
    if constexpr (PG) {
      if (live) {
        // the point's geometry, GZ pair and top evaluated again from its
        // inputs, as the float64 build does: opaque keeps the compiler from
        // sharing that with the forward above, so the training outputs
        // (da, db, the weight gradients) keep the bits of PG = false
        float gx, gy, gz, gr;
        point_adjoint(opaque(ld(x[p])), opaque(ld(y[p])), opaque(ld(z[p])),
                      opaque(ld(r[p])), ry, rz, opaque(av), opaque(bv), psym,
                      opaque(o[0]), opaque(o[1]), opaque(o[2]), opaque(o[3]),
                      opaque(o[4]), opaque(o[5]), opaque(gpsi),
                      opaque(glap), ds[0], ds[1], dc, gx, gy, gz, gr);
        dx_out[p] = kern::st<S>(gx);
        dy_out[p] = kern::st<S>(gy);
        dz_out[p] = kern::st<S>(gz);
        dr_out[p] = kern::st<S>(gr);
      }
    }
    __syncthreads();
    // dW2 += A^T G over the points of the thread's slice, A's triples
    // (t, g w, h w^2) at its four units from t (as the forward has them);
    // db2 += G's first component
    for (int pp = sl; pp < P; pp += PT::NSL) {
      float a[3][4], gv[3][4];
      load4(sA + pp * PA + om * H + 4 * bi, a[0]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        load4(sG + pp * PS + 3 * om * H + c * H + 4 * bk, gv[c]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float t = a[0][u];
        const float g = 1.0f - t * t;
        const float h = -2.0f * t * g;
        a[1][u] = g * w0[u];
        a[2][u] = h * w0[u] * w0[u];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) dw[u][v] += a[c][u] * gv[c][v];
      if (bi == 0) {
#pragma unroll
        for (int v = 0; v < 4; ++v) db2[v] += gv[0][v];
      }
    }
    __syncthreads();
  }

  // the block's row of partial weight gradients, the slices and the warps
  // combined in a fixed order: dW2 [mlp][slice][H][H] and b2
  // [mlp][slice][H] staged over G
  float* st = sG;
  float* stb = sG + 2 * PT::NSL * H * H;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      st[((om * PT::NSL + sl) * H + 4 * bi + u) * H + 4 * bk + v] = dw[u][v];
  if (bi == 0) store4(stb + (om * PT::NSL + sl) * H + 4 * bk, db2);
  __syncthreads();
  float* part = partials + static_cast<size_t>(blockIdx.x) * 2 * WS;
  for (int o = tid; o < 2 * WS; o += P) {
    const int m = o / WS, e = o % WS;
    float acc = 0.0f;
    if (e >= L::W2 && e < L::B2) {
      for (int s = 0; s < PT::NSL; ++s)
        acc += st[(m * PT::NSL + s) * H * H + e - L::W2];
    } else if (e >= L::B2 && e < L::OW) {
      for (int s = 0; s < PT::NSL; ++s)
        acc += stb[(m * PT::NSL + s) * H + e - L::B2];
    } else {
      const int t = e < L::W2   ? e                     // w1, b1
                    : e < L::OB ? 3 * H + e - L::OW     // ow
                                : 4 * H;                // ob
      for (int v = 0; v < PT::WARPS; ++v) acc += sS[(v * 2 + m) * NS + t];
    }
    part[o] = acc;
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename S, int H, bool PG, bool EX>
cudaError_t prepare(size_t* smem) {
  if constexpr (tiled<S>()) {
    static_assert(2 * Dw2<H>::KS * H * H <= 2 * Tile<H>::ROWS * H,
                  "the dW2 staging fits the two tiles");
    *smem = sizeof(S) * smem_elems<S, H, PG>();
    return cudaFuncSetAttribute(separable_bwd_kernel<S, H, PG, EX>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  } else {
    *smem = sizeof(float) * point_smem_elems<H>();
    return cudaFuncSetAttribute(separable_bwd_point_kernel<S, H, PG, EX>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
}

// The pointer arguments of a launch, in the entry points' order.
struct Args {
  const void *x, *y, *z, *r, *a, *b, *c1, *c2, *n0, *w, *dpsi, *dlap;
  void *da, *db, *dc1, *dc2, *dn0, *partials, *dx, *dy, *dz, *dr;
};

template <typename S, int H, bool PG, bool EX>
cudaError_t launch(const Args& g, int n, int psym, int grid, int code,
                   double ry, double rz, cudaStream_t stream) {
  using T = kern::compute_t<S>;  // also the partials' type
  size_t smem;
  cudaError_t err = prepare<S, H, PG, EX>(&smem);
  if (err != cudaSuccess) return err;
  auto in = [](const void* v) { return static_cast<const S*>(v); };
  auto out = [](void* v) { return static_cast<S*>(v); };
  T* ppart = static_cast<T*>(g.partials);
  if constexpr (tiled<S>())
    separable_bwd_kernel<S, H, PG, EX><<<grid, kThreads, smem, stream>>>(
        in(g.x), in(g.y), in(g.z), in(g.r), in(g.a), in(g.b), in(g.c1),
        in(g.c2), in(g.n0), in(g.w), in(g.dpsi), in(g.dlap), out(g.da),
        out(g.db), out(g.dc1), out(g.dc2), out(g.dn0), ppart, out(g.dx),
        out(g.dy), out(g.dz), out(g.dr), n, T(psym), T(ry), T(rz), code);
  else
    separable_bwd_point_kernel<S, H, PG, EX>
        <<<grid, kPointThreads, smem, stream>>>(
            in(g.x), in(g.y), in(g.z), in(g.r), in(g.a), in(g.b), in(g.c1),
            in(g.c2), in(g.n0), in(g.w), in(g.dpsi), in(g.dlap), out(g.da),
            out(g.db), out(g.dc1), out(g.dc2), out(g.dn0), ppart, out(g.dx),
            out(g.dy), out(g.dz), out(g.dr), n, T(psym), T(ry), T(rz),
            code);
  return cudaGetLastError();
}

template <typename S, int H, bool PG>
int occupancy(int* smem_bytes) {
  size_t smem;
  if (prepare<S, H, PG, false>(&smem) != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err;
  if constexpr (tiled<S>())
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, separable_bwd_kernel<S, H, PG, false>, kThreads, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, separable_bwd_point_kernel<S, H, PG, false>, kPointThreads,
        smem);
  if (err != cudaSuccess) return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

// pg: the point-gradient instantiations; code: the factor code (the EX
// instantiations where nonzero). The two exclude each other.
template <typename S>
int dispatch(const Args& g, int n, int hidden, int psym, int grid, int pg,
             int code, double ry, double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pg && (!g.dx || !g.dy || !g.dz || !g.dr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (code < 0 || (pg && code) || (code & 3) == 3 ||
      ((code & 3) > 0 && (!g.c1 || !g.dc1)) ||
      ((code & 3) > 1 && (!g.c2 || !g.dc2)) ||
      (((code >> 2) & 1) && (!g.n0 || !g.dn0)))
    return static_cast<int>(cudaErrorInvalidValue);
#define SEP_BWD_CASE(HH)                                                    \
  case HH:                                                                  \
    return pg     ? launch<S, HH, true, false>(g, n, psym, grid, code, ry,  \
                                               rz, s)                       \
           : code ? launch<S, HH, false, true>(g, n, psym, grid, code, ry,  \
                                               rz, s)                       \
                  : launch<S, HH, false, false>(g, n, psym, grid, code, ry, \
                                                rz, s);
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

// Resident blocks per SM of the instantiation of type code `type`
// (kern::TypeCode) at this width (PG: its point-gradient instantiation), and
// its shared memory per block in *smem_bytes; -1 on error.
template <bool PG>
int occupancy_at(int hidden, int type, int* smem_bytes) {
#define SEP_BWD_OCC(HH)                                                 \
  case HH:                                                              \
    return type == kern::kF64 ? occupancy<double, HH, PG>(smem_bytes)   \
           : type == kern::kBF16                                        \
               ? occupancy<__nv_bfloat16, HH, PG>(smem_bytes)           \
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

// c1, c2, n0: the excited-state nodes a point, dc1, dc2, dn0 their
// cotangents (read and written where the factor code names their factor;
// null otherwise); dx, dy, dz, dr: the point gradients, written when pg !=
// 0 (the PG = true instantiations); null otherwise. partials: the compute
// type's rows (float32 for bfloat16).
#define SEP_BWD_ENTRY(NAME, S)                                                \
  extern "C" int NAME(const void* x, const void* y, const void* z,            \
                      const void* r, const void* a, const void* b,            \
                      const void* c1, const void* c2, const void* n0,         \
                      const void* w, const void* dpsi, const void* dlap,      \
                      void* da, void* db, void* dc1, void* dc2, void* dn0,    \
                      void* partials, void* dx, void* dy, void* dz, void* dr, \
                      int n, int hidden, int psym, int grid, int pg,          \
                      int code, double ry, double rz, void* stream) {         \
    const Args g{x,  y,  z,   r,   a,   b,        c1, c2, n0, w,  dpsi,      \
                 dlap, da, db, dc1, dc2, dn0, partials, dx, dy, dz, dr};     \
    return dispatch<S>(g, n, hidden, psym, grid, pg, code, ry, rz, stream);   \
  }
SEP_BWD_ENTRY(separable_bwd_f64, double)
SEP_BWD_ENTRY(separable_bwd_f32, float)
SEP_BWD_ENTRY(separable_bwd_bf16, __nv_bfloat16)
#undef SEP_BWD_ENTRY

// Points a block takes at a time in the build of type code `type`
// (kern::TypeCode; bfloat16 as float32) at this width (the wrapper's
// grid_blocks must agree), or -1.
extern "C" int separable_bwd_points_per_tile(int hidden, int type) {
#define SEP_BWD_TILE(HH)                                      \
  case HH:                                                    \
    return type == kern::kF64 ? points_per_tile<double, HH>() \
                              : points_per_tile<float, HH>();
  switch (hidden) {
    SEP_BWD_TILE(4)
    SEP_BWD_TILE(8)
    SEP_BWD_TILE(16)
    SEP_BWD_TILE(32)
    default:
      return -1;
  }
#undef SEP_BWD_TILE
}

extern "C" int separable_bwd_occupancy(int hidden, int type,
                                       int* smem_bytes) {
  return occupancy_at<false>(hidden, type, smem_bytes);
}

extern "C" int separable_bwd_pg_occupancy(int hidden, int type,
                                          int* smem_bytes) {
  return occupancy_at<true>(hidden, type, smem_bytes);
}

extern "C" const char* separable_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
