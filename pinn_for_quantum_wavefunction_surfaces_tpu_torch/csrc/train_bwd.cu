// K2 backward: cotangents of the fused (psi, lap psi) symmetric kernel.
//
// Replaces: pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_train.py
//   bwd_kernel (the pl.pallas_call in fused_bwd), which recomputes _core per
//   (32, 128) tile, applies the tile-local jax.vjp, and writes per-point
//   da, db, dg plus per-tile partials of the 6 weight gradients (summed over
//   tiles outside the kernel); with point_grads=True (:191, :206-210) also
//   dx, dy, dz, dr per point: the PG = true instantiations below.
//
// What bounds it on an H100: arithmetic, about three times the forward's:
// 48 H^2 + 290 H + 233 operations per point (17.2k at H = 16;
// chip_smoke.py, train_bwd_ops) against 96 bytes in float64. Per branch the
// three H x H products are 12 H^2 of them: the second layer L = A W2, its
// input cotangents dA = G W2^T, and the weight gradient dW2 = A^T G, a sum
// over points (A: the first layer's 4-stacks, G: the cotangents of the
// second layer's pre-activation stacks). The rest is the 4 H sigmoids of
// the forward and the per-unit adjoints.
//
// The sums over points are the hard part. They run in a FIXED order with no
// atomics, so two launches give the same bits (the trainer's best tracking
// compares losses across steps): a block walks the tiles blockIdx,
// blockIdx + grid, ... of a grid fixed by n, H and the type alone (the
// wrapper's grid_blocks: the resident blocks per SM times 132), keeps its
// sums across its tiles, and writes ONE row of H^2 + 5H + 1 partials at
// the end; the wrapper sums the rows. The per-unit sums (w1, b1, b2, ow) go
// through fixed shuffle trees by recursive halving (common.cuh
// warp_unit_sum), one owner lane a unit, into per-warp sums in shared
// memory. Nothing is evaluated twice: the adjoint of a first-layer unit
// needs only its sigmoid s (kept in A) and the envelopes. Lanes past n
// evaluate the finite pad point with zero cotangents, so everything they
// add is exactly 0.
//
// Design, by type (chosen at compile time):
// - float64 (train_tile.cuh): a block of 256 threads takes tiles of 32
//   points (16 at H = 32). Both branches' first-layer stacks form one
//   [8P, H] tile A; L = A W2 and dA = G W2^T run on the float64 tensor
//   cores (mma.sync m8n8k4 through wmma), and so does dW2 += A^T G, into
//   accumulators each warp keeps in registers across its tiles (a fixed
//   8 x 8 tile and K slice of dW2 a warp). The second layer's epilogue
//   writes G over L; dA is written over G. Shared memory: the weights, two
//   [8P, H + 4] tiles, the per-pair vectors and the per-warp sums, 101 KB
//   at H = 16: 2 blocks of 8 warps an SM, 126 registers, no spills. What
//   bounds it now is not measured (no ncu on the card): it runs at ~7x its
//   operation bound; the 4 H float64 sigmoids a point and the 8 barriers a
//   tile are the likely costs.
// - float32: one thread a point, as the forward (the products of a point
//   from registers, every weight a shared-memory broadcast: one load per 4
//   FMAs); blocks of 128 points. A point's stacks A and cotangents G go to
//   its row of two shared [128, 4H + 4] buffers; dW2 += A^T G is a
//   register-blocked product: each thread owns a 4 x 4 block of dW2 over a
//   fixed slice of the tile's 512 (point, component) rows, two 16-byte
//   shared loads per 16 FMAs, and keeps it across its tiles. The units run
//   in small groups in rolled loops: unrolled, the compiler loads many
//   units' weights ahead and spills. 71 KB of shared memory and 162
//   registers at H = 16: 3 blocks of 4 warps an SM, no spills (capped at 2
//   blocks it needs no cap on registers, and is slower). At ~3x its
//   operation bound, the one-thread-a-point products (the rate of FMA and
//   shared-load instructions) bound it.
//
// - bfloat16 (train_bwd_bf16): the float32 kernel on bfloat16 tensors
//   (storage type S = __nv_bfloat16, compute type float): every value
//   loaded into float, the float32 arithmetic and order of sums; da, db, dg
//   and the point gradients rounded once as they are stored; the rows of
//   partial weight gradients float32 (the wrapper sums them in float32 in
//   their fixed order and rounds once), so two launches agree bit for bit.
//
// Point gradients (PG = true, a compile-time flag of both kernels; PG =
// false is the training path and compiles to the same code as before the
// flag). A branch's adjoint already forms, per unit, the cotangents of the
// unit's pre-activation, gradient coefficients and laplacian; summed over
// the units with the input weights they give the cotangents of the
// branch's envelope stacks (f, g, l of each envelope), and the units' q
// and qq terms give that of c12 (train.cuh unit1_env_cot). Float64: each
// pair's lanes sum these 7 values in a fixed butterfly into 7 more
// per-pair vectors, and the tile's per-point phase carries both branches'
// (and the GZ pair's) through the envelopes and the geometry to dx, dy,
// dz, dr (train.cuh branch_point_adjoint, common.cuh geometry_adjoint; the
// mirrored branch's dx changes sign). Float32: the thread of a point does
// the same in registers after each branch, under the same 3-block bound
// (168 registers; the PG instantiation at H = 16 needs 168 when allowed
// 255). Only live points are written; the weight gradients keep their
// order and bits.

#include "rheads.cuh"
#include "train_tile.cuh"

using namespace trn;
using kern::add_warp_sums;
using kern::load4;
using kern::store4;

namespace {

// ---------------------------------------------------------------------------
// float64: tiles on the tensor cores

// dW2 on the tensor cores: each warp owns FT fixed 8 x 8 tiles of dW2 and,
// when there are fewer tiles than warps, one of KS slices of the 8P rows.
template <int H>
struct Dw2 {
  // 8 x 8 tiles of dW2 (1 where 8 does not divide H: unused there)
  static constexpr int TO = H % 8 == 0 ? (H / 8) * (H / 8) : 1;
  static constexpr int FT = TO >= kTileWarps ? TO / kTileWarps : 1;
  static constexpr int KS = TO >= kTileWarps ? 1 : kTileWarps / TO;
  static constexpr int KROWS = Tile<H>::ROWS / KS;
  static_assert(KROWS % 4 == 0, "a K slice holds whole k-steps");
};

// the scalar dW2 (H = 4): each thread owns outputs tid, tid + 256, ...
template <int H>
__host__ __device__ constexpr int scalar_dw2_per_thread() {
  return (H * H + kTileThreads - 1) / kTileThreads;
}

// per-unit sums of a warp, kept in shared memory across its tiles: w1 row
// 0, w1 row 1, b1, b2, ow
constexpr int kUnitSums = 5;

// PG: each pair's envelope cotangents [kEnvCots][2P] after the sums
template <int H, bool PG>
constexpr int bwd_smem_elems() {
  return tile_smem_elems<H>(2) + kTileWarps * kUnitSums * H +
         (PG ? kEnvCots * Tile<H>::BP : 0);
}

template <typename T, int H, bool PG>
__global__ void __launch_bounds__(kTileThreads, 2)
    train_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ y,
                          const T* __restrict__ z, const T* __restrict__ r,
                          const T* __restrict__ a, const T* __restrict__ b,
                          const T* __restrict__ g, const T* __restrict__ w,
                          const T* __restrict__ dpsi,
                          const T* __restrict__ dlap, T* __restrict__ da_out,
                          T* __restrict__ db_out, T* __restrict__ dg_out,
                          T* __restrict__ partials, T* __restrict__ dx_out,
                          T* __restrict__ dy_out, T* __restrict__ dz_out,
                          T* __restrict__ dr_out, int n, T psym, T ry,
                          T rz) {
  static_assert(std::is_same<T, double>::value, "the float64 design");
  using TL = Tile<H>;
  using L = Layout<H>;
  using D = Dw2<H>;
  constexpr int LD = TL::LD, P = TL::P, BP = TL::BP, UPT = TL::UPT;
  constexpr bool MMA = use_mma<T, H>();
  using namespace nvcuda;
  using Acc = wmma::fragment<wmma::accumulator, 8, 8, 4, double>;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sW2 = sw + TL::WSP;       // [H][LD] W2
  T* sA = sW2 + H * LD;        // [8P][LD] first-layer stacks
  T* sG = sA + TL::ROWS * LD;  // [8P][LD] L, then G, then dA
  T* sV = sG + TL::ROWS * LD;  // [slot][2P] per-pair vectors
  T* sS = sV + kSlots * BP;    // [warp][kUnitSums][H] per-unit sums
  T* sC = sS + kTileWarps * kUnitSums * H;  // PG: [kEnvCots][2P]
  tile_load_weights<T, H>(w, sw, sW2);
  for (int i = threadIdx.x; i < kTileWarps * kUnitSums * H; i += kTileThreads)
    sS[i] = T(0);
  __syncthreads();

  const int tid = threadIdx.x, warp = tid / 32;
  const int bp = my_pair<H>(), q = my_lane<H>();
  T* sums = sS + warp * kUnitSums * H;
  T ob = T(0);
  Acc dacc[D::FT];
  T sacc[scalar_dw2_per_thread<H>()];
  if constexpr (MMA) {
#pragma unroll
    for (int f = 0; f < D::FT; ++f) wmma::fill_fragment(dacc[f], 0.0);
  } else {
#pragma unroll
    for (int o = 0; o < scalar_dw2_per_thread<H>(); ++o) sacc[o] = T(0);
  }

  const int tiles = (n + P - 1) / P;
  const T one = T(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (tid < BP)
      tile_envelopes<T, H>(x, y, z, r, a, g, dpsi, dlap, tile, n, psym, ry,
                           rz, sV);
    __syncthreads();
    const Env<T> e = tile_env<T, H>(sV, bp);
    tile_layer1<T, H>(sw, e, sA);
    __syncthreads();
    tile_product<T, H, false>(sA, sW2, sG);
    __syncthreads();
    // the second layer's units at the thread's pair: the branch output, the
    // cotangents G written over L, the b2 and ow terms
    const T cv = sV[kCv * BP + bp], cl = sV[kCl * BP + bp];
    T ov = T(0), ol = T(0);
    T t2[2][UPT];  // b2, ow
    T dc2 = T(0);  // PG: c12's cotangent through the units' qq
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int k = q + TL::TPP * i;
      T* gk = sG + tile_row<H>(bp, 0) * LD + k;  // component c at c P LD
      const Unit2<T> u = unit2_act(gk[0] + sw[L::B2 + k], gk[P * LD],
                                   gk[2 * P * LD], gk[3 * P * LD], e.c12);
      const T owk = sw[L::OW + k];
      ov += u.bv * owk;
      ol += u.bl * owk;
      const Grad2<T> d = unit2_adjoint(u, e.c12, owk, cv, cl);
      gk[0] = d.g0;
      gk[P * LD] = d.g1;
      gk[2 * P * LD] = d.g2;
      gk[3 * P * LD] = d.g3;
      t2[0][i] = d.g0;
      t2[1][i] = d.dow;
      if constexpr (PG) dc2 += d.dc12;
    }
    warp_unit_sums<H>(t2, sums + 3 * H);
    ov = pair_sum<H>(ov);
    ol = pair_sum<H>(ol);
    if (q == 0) {
      sV[kOv * BP + bp] = ov;
      sV[kOl * BP + bp] = ol;
    }
    __syncthreads();
    // dW2 += A^T G
    if constexpr (MMA) {
#pragma unroll
      for (int f = 0; f < D::FT; ++f) {
        const int tt = D::KS == 1 ? warp + kTileWarps * f : warp % D::TO;
        const int ks = D::KS == 1 ? 0 : warp / D::TO;
        const int i0 = (tt / (H / 8)) * 8, k0 = (tt % (H / 8)) * 8;
#pragma unroll 4
        for (int r0 = ks * D::KROWS; r0 < (ks + 1) * D::KROWS; r0 += 4) {
          // A^T (i, row) = A[row][i]: A read column-major
          wmma::fragment<wmma::matrix_a, 8, 8, 4, double, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sA + r0 * LD + i0, LD);
          wmma::load_matrix_sync(fb, sG + r0 * LD + k0, LD);
          wmma::mma_sync(dacc[f], fa, fb, dacc[f]);
        }
      }
    } else {
#pragma unroll
      for (int o = 0; o < scalar_dw2_per_thread<H>(); ++o) {
        const int el = tid + kTileThreads * o;
        if (el < H * H) {
          const int i = el / H, k = el % H;
          T acc = sacc[o];
          for (int row = 0; row < TL::ROWS; ++row)
            acc += sA[row * LD + i] * sG[row * LD + k];
          sacc[o] = acc;
        }
      }
    }
    __syncthreads();
    tile_product<T, H, true>(sG, sW2, sG);
    __syncthreads();
    // the first layer's adjoint at the thread's pair and units
    const EnvDa<T> kd = env_da(sV[kA * BP + bp], e);
    T dap = T(0);
    T t1[3][UPT];  // w1 row 0, w1 row 1, b1
    T ec[kEnvCots] = {};  // PG: the pair's envelope cotangents
    ec[kCc12] = dc2;
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int j = q + TL::TPP * i;
      const int r0 = tile_row<H>(bp, 0) * LD + j;
      const T w0 = sw[L::W1 + j], w1 = sw[L::W1 + H + j];
      const Grad1<T> d =
          unit1_adjoint(sA[r0], w0, w1, e, sG[r0], sG[r0 + P * LD],
                        sG[r0 + 2 * P * LD], sG[r0 + 3 * P * LD]);
      t1[0][i] = d.dz * e.f1 + d.dga * e.g1 + d.dlz * e.l1;
      t1[1][i] = d.dz * e.f2 + d.dgb * e.g2 + d.dlz * e.l2;
      t1[2][i] = d.dz;
      dap += unit1_da(d, w0, w1, kd);
      if constexpr (PG) unit1_env_cot(d, w0, w1, ec);
    }
    warp_unit_sums<H>(t1, sums);
    dap = pair_sum<H>(dap);
    if (q == 0) sV[kDa * BP + bp] = dap;
    if constexpr (PG) {
#pragma unroll
      for (int c = 0; c < kEnvCots; ++c) {
        const T v = pair_sum<H>(ec[c]);
        if (q == 0) sC[c * BP + bp] = v;
      }
    }
    __syncthreads();
    // one thread a point: the GZ pair's adjoint, da, db, dg
    if (tid < P) {
      const int p = tile * P + tid;
      const bool live = p < n;
      const Env<T> ep = tile_env<T, H>(sV, tid);
      const T gpsi = live ? dpsi[p] : T(0);
      const T glap = live ? dlap[p] : T(0);
      T da = sV[kDa * BP + tid] + sV[kDa * BP + P + tid];
      T db = T(0);
      gz_adjoint(sV[kA * BP + tid], live ? b[p] : one, psym, ep, gpsi, glap,
                 da, db);
      const T nnv = sw[L::OB] + sV[kOv * BP + tid] +
                    psym * sV[kOv * BP + P + tid];
      const T nnl = sV[kOl * BP + tid] + psym * sV[kOl * BP + P + tid];
      if (live) {
        da_out[p] = da;
        db_out[p] = db;
        dg_out[p] = gpsi * nnv + glap * nnl;
      }
      ob += sV[kCv * BP + tid];  // the direct branch's: dpsi g
      if constexpr (PG) {
        if (live) {
          // the GZ pair's geometry cotangents join the direct branch's
          const T av = sV[kA * BP + tid];
          T dr1 = T(0), dr2 = T(0), dc12 = T(0);
          gz_geometry_adjoint(av, b[p], psym, ep, gpsi, glap, dr1, dr2, dc12);
          T px = T(0), py = T(0), pz = T(0), pr = T(0);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int pp = m * P + tid;
            T c[kEnvCots];
#pragma unroll
            for (int k = 0; k < kEnvCots; ++k) c[k] = sC[k * BP + pp];
            branch_point_adjoint(x[p], y[p], z[p], r[p], ry, rz, av, m == 1,
                                 tile_env<T, H>(sV, pp), c,
                                 m == 0 ? dr1 : T(0), m == 0 ? dr2 : T(0),
                                 m == 0 ? dc12 : T(0), px, py, pz, pr);
          }
          dx_out[p] = px;
          dy_out[p] = py;
          dz_out[p] = pz;
          dr_out[p] = pr;
        }
      }
    }
    __syncthreads();
  }

  // the block's row of partial weight gradients, summed in a fixed order:
  // the warps' per-unit sums; ob staged over A by the point lanes, then the
  // warps' dW2 tiles [K slice][H][H]
  __syncthreads();
  T* st = sA;
  constexpr int DW_AT = kTileThreads;  // 32-byte aligned
  static_assert(DW_AT + D::KS * H * H <= 2 * TL::ROWS * LD,
                "the staging fits the two tiles");
  st[tid] = ob;
  if constexpr (MMA) {
#pragma unroll
    for (int f = 0; f < D::FT; ++f) {
      const int tt = D::KS == 1 ? warp + kTileWarps * f : warp % D::TO;
      const int ks = D::KS == 1 ? 0 : warp / D::TO;
      const int i0 = (tt / (H / 8)) * 8, k0 = (tt % (H / 8)) * 8;
      wmma::store_matrix_sync(st + DW_AT + (ks * H + i0) * H + k0,
                              dacc[f], H, wmma::mem_row_major);
    }
  }
  __syncthreads();
  T* part = partials + static_cast<size_t>(blockIdx.x) * L::SIZE;
  for (int o = tid; o < kUnitSums * H + 1; o += kTileThreads) {
    T acc = T(0);
    int dst = L::OB;
    if (o < kUnitSums * H) {
      for (int v = 0; v < kTileWarps; ++v) acc += sS[v * kUnitSums * H + o];
      const int s = o / H, j = o % H;
      dst = s < 3 ? L::W1 + s * H + j : s == 3 ? L::B2 + j : L::OW + j;
    } else {
      for (int t = 0; t < P; ++t) acc += st[t];
    }
    part[dst] = acc;
  }
  if constexpr (MMA) {
    for (int o = tid; o < H * H; o += kTileThreads) {
      T acc = T(0);
      for (int ks = 0; ks < D::KS; ++ks) acc += st[DW_AT + ks * H * H + o];
      part[L::W2 + o] = acc;
    }
  } else {
#pragma unroll
    for (int o = 0; o < scalar_dw2_per_thread<H>(); ++o) {
      const int el = tid + kTileThreads * o;
      if (el < H * H) part[L::W2 + el] = sacc[o];
    }
  }
}

// ---------------------------------------------------------------------------
// float32: one thread a point, register-blocked dW2

template <int H>
struct PointTile {
  static constexpr int P = 128;                  // points (threads) a block
  static constexpr int PS = 4 * H + 4;           // a point's row of A and G
  static constexpr int NB = (H / 4) * (H / 4);   // 4 x 4 blocks of dW2
  static constexpr int NS = P / NB;              // slices of the 4P rows
  static constexpr int WARPS = P / 32;
  static constexpr int NT = 5 * H + 1;           // a warp's per-unit sums
  static constexpr int WSP = (Layout<H>::SIZE + 3) & ~3;
  static_assert(NS * NB == P, "every thread owns a block and a slice");
  static_assert(NS * H * H <= P * PS, "the dW2 staging fits A");
};

template <int H>
constexpr int point_smem_elems() {
  using PT = PointTile<H>;
  return PT::WSP + 2 * PT::P * PT::PS + PT::WARPS * PT::NT;
}

__device__ __forceinline__ void store2(float* dst, const float* v) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}

// S: the tensors' storage type (float or __nv_bfloat16); T = float the
// arithmetic's and the partials' type
template <typename S, int H, bool PG, typename T = kern::compute_t<S>>
__global__ void __launch_bounds__(PointTile<H>::P, H > 16 ? 1 : 3)
    train_bwd_point_kernel(const S* __restrict__ x, const S* __restrict__ y,
                           const S* __restrict__ z, const S* __restrict__ r,
                           const S* __restrict__ a, const S* __restrict__ b,
                           const S* __restrict__ g, const S* __restrict__ w,
                           const S* __restrict__ dpsi,
                           const S* __restrict__ dlap, S* __restrict__ da_out,
                           S* __restrict__ db_out, S* __restrict__ dg_out,
                           T* __restrict__ partials, S* __restrict__ dx_out,
                           S* __restrict__ dy_out, S* __restrict__ dz_out,
                           S* __restrict__ dr_out, int n, T psym, T ry,
                           T rz) {
  static_assert(std::is_same<T, float>::value, "the float32 design");
  using kern::ld;
  using PT = PointTile<H>;
  using L = Layout<H>;
  constexpr int P = PT::P, PS = PT::PS, NS = PT::NS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sA = sw + PT::WSP;  // [P][PS] first-layer stacks
  T* sG = sA + P * PS;   // [P][PS] second-layer cotangents
  T* sS = sG + P * PS;   // [warp][NT] per-unit sums: ow, w1, b1, b2, ob
  for (int i = threadIdx.x; i < L::SIZE; i += P) sw[i] = ld(w[i]);
  for (int i = threadIdx.x; i < PT::WARPS * PT::NT; i += P) sS[i] = T(0);
  __syncthreads();

  const int tid = threadIdx.x, lane = tid % 32;
  T* sums = sS + (tid / 32) * PT::NT;
  // the thread's 4 x 4 block (bi, bk) of dW2 and its slice sl of the rows
  const int bi = (tid % PT::NB) / (H / 4), bk = (tid % PT::NB) % (H / 4);
  const int sl = tid / PT::NB;
  T dw[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) dw[u][v] = T(0);
  T* rowA = sA + tid * PS;
  T* rowG = sG + tid * PS;

  const int tiles = (n + P - 1) / P;
  const T one = T(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p = tile * P + tid;
    const bool live = p < n;
    T nnv = sw[L::OB], nnl = T(0), da = T(0);
    T px = T(0), py = T(0), pz = T(0), pr = T(0);  // PG: the point gradient
    // one branch after the other; the inputs are read again where needed
    // rather than held in registers across the branches
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      const T pb = m == 0 ? one : psym;
      const T av = live ? ld(a[p]) : one;
      Env<T> e;
      branch_envelopes(live ? ld(x[p]) : one, live ? ld(y[p]) : one,
                       live ? ld(z[p]) : one, live ? ld(r[p]) : one, ry, rz,
                       av, m == 1, e);
      // cotangents of the gated network's (value, laplacian)
      const T gv = live ? ld(g[p]) : one;
      const T cv = (live ? ld(dpsi[p]) : T(0)) * gv;
      const T bcv = pb * cv, bcl = pb * ((live ? ld(dlap[p]) : T(0)) * gv);
      if (m == 0) {  // ob: the sum of cv
        T c1[1] = {cv};
        warp_unit_sum<1, 1>(c1, lane);
        if (lane == 0) sums[5 * H] += c1[0];
      }
      // forward: the stacks A to this point's row of A, the cotangents G of
      // the second layer's pre-activations to its row of G; the units in
      // pairs in a rolled loop (unrolled, or in larger groups, the compiler
      // loads the weights of many units ahead and spills)
      T a0[H], a1[H], a2[H], a3[H];
      layer1<T, H>(sw, e, a0, a1, a2, a3);
#pragma unroll
      for (int j = 0; j < H; j += 4) {
        store4(rowA + j, a0 + j);
        store4(rowA + H + j, a1 + j);
        store4(rowA + 2 * H + j, a2 + j);
        store4(rowA + 3 * H + j, a3 + j);
      }
      T ov = T(0), ol = T(0);
      T ec[kEnvCots] = {};  // PG: the branch's envelope cotangents
#pragma unroll 1
      for (int k0 = 0; k0 < H; k0 += 2) {
        T gq[4][2], dow[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int k = k0 + kk;
          const Unit2<T> u = unit2<T, H>(sw, k, e, a0, a1, a2, a3);
          const T owk = sw[L::OW + k];
          ov += u.bv * owk;
          ol += u.bl * owk;
          const Grad2<T> d = unit2_adjoint(u, e.c12, owk, bcv, bcl);
          if constexpr (PG) ec[kCc12] += d.dc12;
          dow[kk] = d.dow;
          gq[0][kk] = d.g0;
          gq[1][kk] = d.g1;
          gq[2][kk] = d.g2;
          gq[3][kk] = d.g3;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) store2(rowG + c * H + k0, gq[c]);
        add_warp_sums<2>(dow, sums + k0, lane);
        add_warp_sums<2>(gq[0], sums + 4 * H + k0, lane);
      }
      nnv += pb * ov;
      nnl += pb * ol;
      __syncthreads();
      // dW2 += A^T G over the rows (point pp, component c) = (row / 4,
      // row % 4) of the thread's slice
      for (int row = sl; row < 4 * P; row += NS) {
        const int pp = row >> 2, c = row & 3;
        T av4[4], gv4[4];
        load4(sA + pp * PS + c * H + 4 * bi, av4);
        load4(sG + pp * PS + c * H + 4 * bk, gv4);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) dw[u][v] += av4[u] * gv4[v];
      }
      __syncthreads();
      // dA = G W2^T from this point's row of G, then the first layer's
      // adjoint, in groups of 4 units; G is read a 4 x 4 block at a time
      // (held whole, its 4H values would spill). The rows are this
      // thread's own, so the next branch may write them without a barrier.
      const EnvDa<T> kd = env_da(av, e);
#pragma unroll 1
      for (int i0 = 0; i0 < H; i0 += 4) {
        T dac[4][4];  // [component][unit]
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) dac[c][ii] = T(0);
#pragma unroll
        for (int k0 = 0; k0 < H; k0 += 4) {
          T gk[4][4];
#pragma unroll
          for (int c = 0; c < 4; ++c) load4(rowG + c * H + k0, gk[c]);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const T wv = sw[L::W2 + (i0 + ii) * H + k0 + kk];
#pragma unroll
              for (int c = 0; c < 4; ++c) dac[c][ii] += gk[c][kk] * wv;
            }
        }
        T s4[4], t0[4], t1[4], t2[4];
        load4(rowA + i0, s4);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = i0 + ii;
          const T w0 = sw[L::W1 + i], w1 = sw[L::W1 + H + i];
          const Grad1<T> d = unit1_adjoint(s4[ii], w0, w1, e, dac[0][ii],
                                           dac[1][ii], dac[2][ii], dac[3][ii]);
          t0[ii] = d.dz * e.f1 + d.dga * e.g1 + d.dlz * e.l1;
          t1[ii] = d.dz * e.f2 + d.dgb * e.g2 + d.dlz * e.l2;
          t2[ii] = d.dz;
          da += unit1_da(d, w0, w1, kd);
          if constexpr (PG) unit1_env_cot(d, w0, w1, ec);
        }
        add_warp_sums<4>(t0, sums + H + i0, lane);
        add_warp_sums<4>(t1, sums + 2 * H + i0, lane);
        add_warp_sums<4>(t2, sums + 3 * H + i0, lane);
      }
      if constexpr (PG)
        branch_point_adjoint(live ? ld(x[p]) : one, live ? ld(y[p]) : one,
                             live ? ld(z[p]) : one, live ? ld(r[p]) : one, ry,
                             rz, av, m == 1, e, ec, T(0), T(0), T(0), px, py,
                             pz, pr);
    }
    const T av = live ? ld(a[p]) : one;
    const T gpsi = live ? ld(dpsi[p]) : T(0);
    const T glap = live ? ld(dlap[p]) : T(0);
    Env<T> e0;
    branch_envelopes(live ? ld(x[p]) : one, live ? ld(y[p]) : one,
                     live ? ld(z[p]) : one, live ? ld(r[p]) : one, ry, rz, av,
                     false, e0);
    T db = T(0);
    gz_adjoint(av, live ? ld(b[p]) : one, psym, e0, gpsi, glap, da, db);
    if (live) {
      da_out[p] = kern::st<S>(da);
      db_out[p] = kern::st<S>(db);
      dg_out[p] = kern::st<S>(gpsi * nnv + glap * nnl);
    }
    if constexpr (PG) {
      if (live) {
        // the GZ pair, on the direct geometry
        T dr1 = T(0), dr2 = T(0), dc12 = T(0);
        gz_geometry_adjoint(av, ld(b[p]), psym, e0, gpsi, glap, dr1, dr2,
                            dc12);
        T tx, ty, tz, tr;
        kern::geometry_adjoint(ld(x[p]), ld(y[p]), ld(z[p]), ld(r[p]), ry, rz,
                               e0.i1, e0.i2, e0.c12, dr1, dr2, dc12, tx, ty,
                               tz, tr);
        dx_out[p] = kern::st<S>(px + tx);
        dy_out[p] = kern::st<S>(py + ty);
        dz_out[p] = kern::st<S>(pz + tz);
        dr_out[p] = kern::st<S>(pr + tr);
      }
    }
  }

  // the block's row of partial weight gradients, the slices and the warps
  // combined in a fixed order: dW2 [slice][H][H] staged over A
  __syncthreads();
  T* st = sA;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      st[(sl * H + 4 * bi + u) * H + 4 * bk + v] = dw[u][v];
  __syncthreads();
  T* part = partials + static_cast<size_t>(blockIdx.x) * L::SIZE;
  for (int o = tid; o < L::SIZE; o += P) {
    T acc = T(0);
    if (o >= L::W2 && o < L::B2) {
      for (int s = 0; s < NS; ++s) acc += st[s * H * H + o - L::W2];
    } else {
      // the warps' sums: ow at 0, w1 and b1 (packed 0 .. 3H) at H .., b2
      // at 4H, ob at 5H
      const int t = o < L::W2   ? H + o
                    : o < L::OW ? 4 * H + o - L::B2
                    : o < L::OB ? o - L::OW
                                : 5 * H;
      for (int v = 0; v < PT::WARPS; ++v) acc += sS[v * PT::NT + t];
    }
    part[o] = acc;
  }
}

// ---------------------------------------------------------------------------
// launch

// S: the tensors' storage type; the float64 build runs on tiles, the
// float32 and bfloat16 builds one thread a point (in float).
template <typename S, int H, bool PG>
cudaError_t prepare(size_t* smem) {
  if constexpr (std::is_same<S, double>::value) {
    *smem = sizeof(S) * bwd_smem_elems<H, PG>();
    return cudaFuncSetAttribute(train_bwd_tile_kernel<S, H, PG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  } else {
    *smem = sizeof(float) * point_smem_elems<H>();
    return cudaFuncSetAttribute(train_bwd_point_kernel<S, H, PG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
}

template <typename T, int H>
constexpr int points_per_tile() {
  return std::is_same<T, double>::value ? Tile<H>::P : PointTile<H>::P;
}

template <typename T, int H>
constexpr int threads() {
  return std::is_same<T, double>::value ? kTileThreads : PointTile<H>::P;
}

template <typename S, int H, bool PG>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* g, const void* w,
                   const void* dpsi, const void* dlap, void* da, void* db,
                   void* dg, void* partials, void* dx, void* dy, void* dz,
                   void* dr, int n, int psym, int grid, double ry, double rz,
                   cudaStream_t stream) {
  using T = kern::compute_t<S>;  // also the partials' type
  size_t smem;
  cudaError_t err = prepare<S, H, PG>(&smem);
  if (err != cudaSuccess) return err;
  const S* px = static_cast<const S*>(x);
  const S* py = static_cast<const S*>(y);
  const S* pz = static_cast<const S*>(z);
  const S* pr = static_cast<const S*>(r);
  const S* pa = static_cast<const S*>(a);
  const S* pb = static_cast<const S*>(b);
  const S* pg = static_cast<const S*>(g);
  const S* pw = static_cast<const S*>(w);
  const S* pdpsi = static_cast<const S*>(dpsi);
  const S* pdlap = static_cast<const S*>(dlap);
  T* ppart = static_cast<T*>(partials);
  S* outs[7] = {static_cast<S*>(da), static_cast<S*>(db),
                static_cast<S*>(dg), static_cast<S*>(dx),
                static_cast<S*>(dy), static_cast<S*>(dz),
                static_cast<S*>(dr)};
  if constexpr (std::is_same<S, double>::value)
    train_bwd_tile_kernel<S, H, PG><<<grid, threads<S, H>(), smem, stream>>>(
        px, py, pz, pr, pa, pb, pg, pw, pdpsi, pdlap, outs[0], outs[1],
        outs[2], ppart, outs[3], outs[4], outs[5], outs[6], n, T(psym),
        T(ry), T(rz));
  else
    train_bwd_point_kernel<S, H, PG><<<grid, threads<S, H>(), smem, stream>>>(
        px, py, pz, pr, pa, pb, pg, pw, pdpsi, pdlap, outs[0], outs[1],
        outs[2], ppart, outs[3], outs[4], outs[5], outs[6], n, T(psym),
        T(ry), T(rz));
  return cudaGetLastError();
}

template <typename S, int H, bool PG>
int occupancy(int* smem_bytes) {
  size_t smem;
  if (prepare<S, H, PG>(&smem) != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err;
  if constexpr (std::is_same<S, double>::value)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_bwd_tile_kernel<S, H, PG>, threads<S, H>(), smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_bwd_point_kernel<S, H, PG>, threads<S, H>(), smem);
  if (err != cudaSuccess) return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

template <typename S>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* g, const void* w,
             const void* dpsi, const void* dlap, void* da, void* db, void* dg,
             void* partials, void* dx, void* dy, void* dz, void* dr, int n,
             int hidden, int psym, int grid, int pg, double ry, double rz,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pg && (!dx || !dy || !dz || !dr))
    return static_cast<int>(cudaErrorInvalidValue);
#define TRAIN_BWD_CASE(HH)                                                  \
  case HH:                                                                  \
    return pg ? launch<S, HH, true>(x, y, z, r, a, b, g, w, dpsi, dlap, da, \
                                    db, dg, partials, dx, dy, dz, dr, n,    \
                                    psym, grid, ry, rz, s)                  \
              : launch<S, HH, false>(x, y, z, r, a, b, g, w, dpsi, dlap,    \
                                     da, db, dg, partials, dx, dy, dz, dr,  \
                                     n, psym, grid, ry, rz, s);
  switch (hidden) {
    TRAIN_BWD_CASE(4)
    TRAIN_BWD_CASE(8)
    TRAIN_BWD_CASE(16)
    TRAIN_BWD_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRAIN_BWD_CASE
}

// Resident blocks per SM of the instantiation of type code `type`
// (kern::TypeCode) at this width (PG: its point-gradient instantiation), and
// its shared memory per block in *smem_bytes; -1 on error.
template <bool PG>
int occupancy_at(int hidden, int type, int* smem_bytes) {
#define TRAIN_BWD_OCC(HH)                                             \
  case HH:                                                            \
    return type == kern::kF64 ? occupancy<double, HH, PG>(smem_bytes) \
           : type == kern::kBF16                                      \
               ? occupancy<__nv_bfloat16, HH, PG>(smem_bytes)         \
               : occupancy<float, HH, PG>(smem_bytes);
  switch (hidden) {
    TRAIN_BWD_OCC(4)
    TRAIN_BWD_OCC(8)
    TRAIN_BWD_OCC(16)
    TRAIN_BWD_OCC(32)
    default:
      return -1;
  }
#undef TRAIN_BWD_OCC
}

}  // namespace

// dx, dy, dz, dr: the point gradients, written when pg != 0 (the PG = true
// instantiations); null otherwise.
extern "C" int train_bwd_f64(const void* x, const void* y, const void* z,
                             const void* r, const void* a, const void* b,
                             const void* g, const void* w, const void* dpsi,
                             const void* dlap, void* da, void* db, void* dg,
                             void* partials, void* dx, void* dy, void* dz,
                             void* dr, int n, int hidden, int psym, int grid,
                             int pg, double ry, double rz, void* stream) {
  return dispatch<double>(x, y, z, r, a, b, g, w, dpsi, dlap, da, db, dg,
                          partials, dx, dy, dz, dr, n, hidden, psym, grid, pg,
                          ry, rz, stream);
}

extern "C" int train_bwd_f32(const void* x, const void* y, const void* z,
                             const void* r, const void* a, const void* b,
                             const void* g, const void* w, const void* dpsi,
                             const void* dlap, void* da, void* db, void* dg,
                             void* partials, void* dx, void* dy, void* dz,
                             void* dr, int n, int hidden, int psym, int grid,
                             int pg, double ry, double rz, void* stream) {
  return dispatch<float>(x, y, z, r, a, b, g, w, dpsi, dlap, da, db, dg,
                         partials, dx, dy, dz, dr, n, hidden, psym, grid, pg,
                         ry, rz, stream);
}

// partials: float32 rows, as in the float32 build
extern "C" int train_bwd_bf16(const void* x, const void* y, const void* z,
                              const void* r, const void* a, const void* b,
                              const void* g, const void* w, const void* dpsi,
                              const void* dlap, void* da, void* db, void* dg,
                              void* partials, void* dx, void* dy, void* dz,
                              void* dr, int n, int hidden, int psym, int grid,
                              int pg, double ry, double rz, void* stream) {
  return dispatch<__nv_bfloat16>(x, y, z, r, a, b, g, w, dpsi, dlap, da, db,
                                 dg, partials, dx, dy, dz, dr, n, hidden,
                                 psym, grid, pg, ry, rz, stream);
}

// Points a block takes at a time in the build of type code `type`
// (kern::TypeCode; bfloat16 as float32) (the wrapper's grid_blocks must
// agree), or -1.
extern "C" int train_bwd_points_per_tile(int hidden, int type) {
#define TRAIN_BWD_TILE(HH)                                    \
  case HH:                                                    \
    return type == kern::kF64 ? points_per_tile<double, HH>() \
                              : points_per_tile<float, HH>();
  switch (hidden) {
    TRAIN_BWD_TILE(4)
    TRAIN_BWD_TILE(8)
    TRAIN_BWD_TILE(16)
    TRAIN_BWD_TILE(32)
    default:
      return -1;
  }
#undef TRAIN_BWD_TILE
}

extern "C" int train_bwd_occupancy(int hidden, int type, int* smem_bytes) {
  return occupancy_at<false>(hidden, type, smem_bytes);
}

extern "C" int train_bwd_pg_occupancy(int hidden, int type, int* smem_bytes) {
  return occupancy_at<true>(hidden, type, smem_bytes);
}

// ---------------------------------------------------------------------------
// The R-heads backward (rheads.cuh): the heads' weight gradients as one row
// of partials a block (float32 rows for bfloat16), r's cotangent dr when dr
// is not null; de, da, db, dg null are zero cotangents.

namespace {

template <typename S, int HE>
cudaError_t rheads_prepare(int hg, int ha, int hb, size_t* smem) {
  using T = kern::compute_t<S>;
  *smem = sizeof(T) * rhd::bwd_smem_elems<HE>(rhd::heads_of<HE>(hg, ha, hb));
  return cudaFuncSetAttribute(rhd::rheads_bwd_kernel<S, HE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename S, int HE>
cudaError_t rheads_launch(const void* r, const void* w, const void* de,
                          const void* da, const void* db, const void* dg,
                          void* partials, void* dr, int n, int psym, int grid,
                          int hg, int ha, int hb, cudaStream_t stream) {
  using T = kern::compute_t<S>;
  size_t smem;
  cudaError_t err = rheads_prepare<S, HE>(hg, ha, hb, &smem);
  if (err != cudaSuccess) return err;
  rhd::rheads_bwd_kernel<S, HE><<<grid, rhd::kThreads, smem, stream>>>(
      static_cast<const S*>(r), static_cast<const S*>(w),
      static_cast<const S*>(de), static_cast<const S*>(da),
      static_cast<const S*>(db), static_cast<const S*>(dg),
      static_cast<T*>(partials), static_cast<S*>(dr), n, hg, ha, hb,
      T(psym));
  return cudaGetLastError();
}

template <typename S, int HE>
int rheads_occupancy(int hr, int* smem_bytes) {
  size_t smem;
  if (rheads_prepare<S, HE>(hr, hr, hr, &smem) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, rhd::rheads_bwd_kernel<S, HE>, rhd::kThreads, smem) !=
      cudaSuccess)
    return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

template <typename S>
int rheads_dispatch(const void* r, const void* w, const void* de,
                    const void* da, const void* db, const void* dg,
                    void* partials, void* dr, int n, int he, int psym,
                    int grid, int hg, int ha, int hb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hg < 1 || ha < 0 || hb < 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define RHEADS_BWD_CASE(HH)                                                 \
  case HH:                                                                  \
    return rheads_launch<S, HH>(r, w, de, da, db, dg, partials, dr, n, psym, \
                                grid, hg, ha, hb, s);
  switch (he) {
    RHEADS_BWD_CASE(4)
    RHEADS_BWD_CASE(8)
    RHEADS_BWD_CASE(16)
    RHEADS_BWD_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RHEADS_BWD_CASE
}

}  // namespace

extern "C" int rheads_bwd_f64(const void* r, const void* w, const void* de,
                              const void* da, const void* db, const void* dg,
                              void* partials, void* dr, int n, int he,
                              int psym, int grid, int hg, int ha, int hb,
                              void* stream) {
  return rheads_dispatch<double>(r, w, de, da, db, dg, partials, dr, n, he,
                                 psym, grid, hg, ha, hb, stream);
}

extern "C" int rheads_bwd_f32(const void* r, const void* w, const void* de,
                              const void* da, const void* db, const void* dg,
                              void* partials, void* dr, int n, int he,
                              int psym, int grid, int hg, int ha, int hb,
                              void* stream) {
  return rheads_dispatch<float>(r, w, de, da, db, dg, partials, dr, n, he,
                                psym, grid, hg, ha, hb, stream);
}

// partials: float32 rows, as in the float32 build
extern "C" int rheads_bwd_bf16(const void* r, const void* w, const void* de,
                               const void* da, const void* db, const void* dg,
                               void* partials, void* dr, int n, int he,
                               int psym, int grid, int hg, int ha, int hb,
                               void* stream) {
  return rheads_dispatch<__nv_bfloat16>(r, w, de, da, db, dg, partials, dr,
                                        n, he, psym, grid, hg, ha, hb,
                                        stream);
}

// Resident blocks per SM at E width he with every rank-1 head hr units
// wide, and the shared memory per block in *smem_bytes; -1 on error.
extern "C" int rheads_bwd_occupancy(int he, int hr, int type,
                                    int* smem_bytes) {
#define RHEADS_BWD_OCC(HH)                                                  \
  case HH:                                                                  \
    return type == kern::kF64 ? rheads_occupancy<double, HH>(hr, smem_bytes) \
           : type == kern::kBF16                                            \
               ? rheads_occupancy<__nv_bfloat16, HH>(hr, smem_bytes)        \
               : rheads_occupancy<float, HH>(hr, smem_bytes);
  switch (he) {
    RHEADS_BWD_OCC(4)
    RHEADS_BWD_OCC(8)
    RHEADS_BWD_OCC(16)
    RHEADS_BWD_OCC(32)
    default:
      return -1;
  }
#undef RHEADS_BWD_OCC
}

extern "C" const char* train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
