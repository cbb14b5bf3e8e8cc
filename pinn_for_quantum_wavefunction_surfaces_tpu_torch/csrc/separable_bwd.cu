// K1 backward: cotangents of the fused (psi, lap psi) separable kernel.
//
// Replaces: pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_separable.py
//   bwd_kernel (the pl.pallas_call in fused_bwd), which recomputes _core per
//   (48, 128) tile, applies the tile-local jax.vjp, and writes per-point
//   da, db plus per-tile partials of the 12 weight gradients (summed over
//   tiles outside the kernel). Points are constants (point_grads=False).
//
// What bounds it on an H100: arithmetic, as the forward, about three times
// over: the forward, the MLP adjoints (3 H^2 multiply-adds each for the
// input cotangents) and the weight-gradient reduction (3 H^2 per point and
// MLP). That is 36 H^2 + 178 H + 236, ~12.3k operations per point at H = 16
// (chip_smoke.py, bwd_ops), against 80 bytes. mlp_stage evaluates each
// MLP's first two layers a second time rather than holding them in
// registers from the forward: ~3.6k more operations per point at H = 16.
//
// Design: one thread per point, BWD_POINTS points per block. Each thread
// recomputes its forward in registers and runs the hand-written adjoint
// (psi_lap_separable_vjp_plain, transliterated). Weight gradients are sums
// over points; per block they are reduced in a FIXED order with no atomics,
// so two launches give the same bits (best-iterate selection in L-BFGS
// compares values across steps). For that, each thread stages its
// first-layer triples a1, second-layer cotangent triples glin and its other
// per-weight contributions in shared memory; after one barrier, each output
// weight is summed by one thread over the block's points in order. Rows of
// the staging buffers are padded to BWD_POINTS + 1 so that both the
// per-thread writes and the per-weight reads are free of bank conflicts.
// The buffers take ((9 H + 2)(BWD_POINTS + 1) + 2 (H^2 + 5 H + 1)) values:
// 81 KB in float64 at H = 16, so the launch opts in to dynamic shared
// memory above 48 KB. Lanes past n evaluate the finite pad point with zero
// cotangents, so every contribution they stage is exactly 0.

#include "separable.cuh"

using namespace sep;

namespace {

constexpr int kPoints = 64;     // threads (points) per block
constexpr int kLd = kPoints + 1;  // padded row stride of the staging buffers

template <int H>
constexpr int smem_elems() {
  return 2 * Layout<H>::SIZE + (9 * H + 2) * kLd;
}

// Stage one MLP's per-point contributions for the block reduction.
template <typename T, int H>
__device__ __forceinline__ void mlp_stage(const T* W, T s, T cf, T d0, T d1,
                                          T d2, int tid, T* sA, T* sG, T* sD,
                                          T* sE, T* sC) {
  using L = Layout<H>;
  T a0[H], a1[H], a2[H];
  mlp_first<T, H>(W, s, cf, a0, a1, a2);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    sA[j * kLd + tid] = a0[j];
    sA[(H + j) * kLd + tid] = a1[j];
    sA[(2 * H + j) * kLd + tid] = a2[j];
  }
  // second layer: forward and adjoint of neuron k
#pragma unroll
  for (int k = 0; k < H; ++k) {
    T l0, l1, l2;
    mlp_lin<T, H>(W, k, a0, a1, a2, l0, l1, l2);
    const T u = m_tanh(l0);
    const T gg = T(1) - u * u;
    const T hh = T(-2) * u * gg;
    const T owk = W[L::OW + k];
    sD[k * kLd + tid] = u * d0 + (gg * l1) * d1 + (gg * l2 + hh * l1 * l1) * d2;
    const T db0 = d0 * owk, db1 = d1 * owk, db2 = d2 * owk;
    const T dlin1 = db1 * gg + db2 * T(2) * hh * l1;
    const T dlin2 = db2 * gg;
    T dgg = db1 * l1 + db2 * l2;
    const T dhh = db2 * l1 * l1;
    T du = db0 - T(2) * gg * dhh;
    dgg = dgg - T(2) * u * dhh;
    du = du - T(2) * u * dgg;
    sG[k * kLd + tid] = du * gg;
    sG[(H + k) * kLd + tid] = dlin1;
    sG[(2 * H + k) * kLd + tid] = dlin2;
  }
  // first layer: cotangent of the seed triple (z0, w, 0) of neuron i
#pragma unroll
  for (int i = 0; i < H; ++i) {
    T da0 = T(0), da1 = T(0), da2 = T(0);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const T wik = W[L::W2 + i * H + k];
      da0 += sG[k * kLd + tid] * wik;
      da1 += sG[(H + k) * kLd + tid] * wik;
      da2 += sG[(2 * H + k) * kLd + tid] * wik;
    }
    const T w = W[L::W1 + i];
    const T t = a0[i];
    const T g = T(1) - t * t;
    const T h = T(-2) * t * g;
    const T dz1 = da1 * g + da2 * T(2) * h * w;
    T dg = da1 * w;
    const T dh = da2 * w * w;
    T dt = da0 - T(2) * g * dh;
    dg = dg - T(2) * t * dh;
    dt = dt - T(2) * t * dg;
    const T dz0 = dt * g;
    sE[i * kLd + tid] = s * dz0 + dz1;
    sE[(H + i) * kLd + tid] = dz0;
  }
  sC[tid] = cf;
  sC[kLd + tid] = d0;
}

// Sum over the block's points, in order, of one weight's contributions.
template <typename T, int H>
__device__ __forceinline__ T reduce_weight(int o, const T* sA, const T* sG,
                                           const T* sD, const T* sE,
                                           const T* sC) {
  using L = Layout<H>;
  T acc = T(0);
  if (o < L::B1) {
    if (o < H) {  // w1[0][j]: sum (s dz0 + dz1)
      for (int p = 0; p < kPoints; ++p) acc += sE[o * kLd + p];
    } else {      // w1[1][j]: sum cf dz0
      const int j = o - H;
      for (int p = 0; p < kPoints; ++p) acc += sC[p] * sE[(H + j) * kLd + p];
    }
  } else if (o < L::W2) {  // b1[j]: sum dz0
    const int j = o - L::B1;
    for (int p = 0; p < kPoints; ++p) acc += sE[(H + j) * kLd + p];
  } else if (o < L::B2) {  // w2[i][k]: sum_c a1_i[c] glin_k[c]
    const int i = (o - L::W2) / H, k = (o - L::W2) % H;
    for (int p = 0; p < kPoints; ++p)
      acc += sA[i * kLd + p] * sG[k * kLd + p] +
             sA[(H + i) * kLd + p] * sG[(H + k) * kLd + p] +
             sA[(2 * H + i) * kLd + p] * sG[(2 * H + k) * kLd + p];
  } else if (o < L::OW) {  // b2[k]: sum glin_k[0]
    const int k = o - L::B2;
    for (int p = 0; p < kPoints; ++p) acc += sG[k * kLd + p];
  } else if (o < L::OB) {  // ow[k]: sum_c a2_k[c] dout[c]
    const int k = o - L::OW;
    for (int p = 0; p < kPoints; ++p) acc += sD[k * kLd + p];
  } else {                 // ob: sum dout[0]
    for (int p = 0; p < kPoints; ++p) acc += sC[kLd + p];
  }
  return acc;
}

template <typename T, int H>
__global__ void __launch_bounds__(kPoints)
    separable_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ z, const T* __restrict__ r,
                         const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ w, const T* __restrict__ dpsi,
                         const T* __restrict__ dlap, T* __restrict__ da_out,
                         T* __restrict__ db_out, T* __restrict__ partials,
                         int n, T psym, T ry, T rz) {
  constexpr int WS = Layout<H>::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sA = sw + 2 * WS;        // [3H][kLd] first-layer triples
  T* sG = sA + 3 * H * kLd;   // [3H][kLd] second-layer cotangent triples
  T* sD = sG + 3 * H * kLd;   // [H][kLd]  output-weight contributions
  T* sE = sD + H * kLd;       // [2H][kLd] first-layer contributions
  T* sC = sE + 2 * H * kLd;   // [2][kLd]  cf and the output cotangent
  for (int i = threadIdx.x; i < 2 * WS; i += kPoints) sw[i] = w[i];
  __syncthreads();

  const int tid = threadIdx.x;
  const int p = blockIdx.x * kPoints + tid;
  const bool live = p < n;
  const T one = T(1);
  Point<T> pt;
  point_setup(live ? x[p] : one, live ? y[p] : one, live ? z[p] : one,
              live ? r[p] : one, ry, rz, pt);
  const T av = live ? a[p] : one;
  const T bv = live ? b[p] : one;
  const T gpsi = live ? dpsi[p] : T(0);
  const T glap = live ? dlap[p] : T(0);

  T l0, l1, l2, m0, m1, m2;
  mlp_fwd<T, H>(sw, pt.t0, pt.cf, l0, l1, l2);
  mlp_fwd<T, H>(sw + WS, pt.e0, pt.cf, m0, m1, m2);
  const GZ<T> g = gz(av, bv, psym, pt);
  Top<T> st;
  top_forward(l0, l1, l2, m0, m1, m2, g, pt, st);
  const TopGrad<T> tg = top_adjoint(av, bv, l1, m1, gpsi, glap, g, pt, st);
  if (live) {
    da_out[p] = tg.da;
    db_out[p] = tg.db;
  }

  T* part = partials + static_cast<size_t>(blockIdx.x) * 2 * WS;
  for (int m = 0; m < 2; ++m) {
    const T* W = sw + m * WS;
    if (m == 0)
      mlp_stage<T, H>(W, pt.t0, pt.cf, tg.dq0, tg.dl1, tg.dl2, tid, sA, sG, sD,
                      sE, sC);
    else
      mlp_stage<T, H>(W, pt.e0, pt.cf, tg.dq0, tg.dm1, tg.dm2, tid, sA, sG, sD,
                      sE, sC);
    __syncthreads();
    for (int o = tid; o < WS; o += kPoints)
      part[m * WS + o] = reduce_weight<T, H>(o, sA, sG, sD, sE, sC);
    __syncthreads();
  }
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* w,
                   const void* dpsi, const void* dlap, void* da, void* db,
                   void* partials, int n, int psym, double ry, double rz,
                   cudaStream_t stream) {
  const int blocks = (n + kPoints - 1) / kPoints;
  const size_t smem = sizeof(T) * smem_elems<H>();
  cudaError_t err = cudaFuncSetAttribute(
      separable_bwd_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  separable_bwd_kernel<T, H><<<blocks, kPoints, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(w), static_cast<const T*>(dpsi),
      static_cast<const T*>(dlap), static_cast<T*>(da), static_cast<T*>(db),
      static_cast<T*>(partials), n, T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* w, const void* dpsi,
             const void* dlap, void* da, void* db, void* partials, int n,
             int hidden, int psym, double ry, double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEP_BWD_CASE(HH)                                                    \
  case HH:                                                                  \
    return launch<T, HH>(x, y, z, r, a, b, w, dpsi, dlap, da, db, partials, \
                         n, psym, ry, rz, s);
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

}  // namespace

extern "C" int separable_bwd_points_per_block() { return kPoints; }

extern "C" int separable_bwd_f64(const void* x, const void* y, const void* z,
                                 const void* r, const void* a, const void* b,
                                 const void* w, const void* dpsi,
                                 const void* dlap, void* da, void* db,
                                 void* partials, int n, int hidden, int psym,
                                 double ry, double rz, void* stream) {
  return dispatch<double>(x, y, z, r, a, b, w, dpsi, dlap, da, db, partials, n,
                          hidden, psym, ry, rz, stream);
}

extern "C" int separable_bwd_f32(const void* x, const void* y, const void* z,
                                 const void* r, const void* a, const void* b,
                                 const void* w, const void* dpsi,
                                 const void* dlap, void* da, void* db,
                                 void* partials, int n, int hidden, int psym,
                                 double ry, double rz, void* stream) {
  return dispatch<float>(x, y, z, r, a, b, w, dpsi, dlap, da, db, partials, n,
                         hidden, psym, ry, rz, stream);
}

extern "C" const char* separable_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
