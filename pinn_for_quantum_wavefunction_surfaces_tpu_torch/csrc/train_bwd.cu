// K2 backward: cotangents of the fused (psi, lap psi) symmetric kernel.
//
// Replaces: pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_train.py
//   bwd_kernel (the pl.pallas_call in fused_bwd), which recomputes _core per
//   (32, 128) tile, applies the tile-local jax.vjp, and writes per-point
//   da, db, dg plus per-tile partials of the 6 weight gradients (summed over
//   tiles outside the kernel). Points are constants (point_grads=False).
//
// What bounds it on an H100: arithmetic, as the forward, about three times
// over: 48 H^2 + 290 H + 233 operations per point (17.2k at H = 16;
// chip_smoke.py, train_bwd_ops): per branch the forward, the input
// cotangents of the second layer (4 H^2 multiply-adds) and the weight
// gradient of w2 (4 H^2 multiply-adds), against 96 bytes per point in
// float64. The kernel evaluates each first-layer unit a second time in the
// adjoint (train.cuh unit1) rather than hold it in registers; that work is
// not counted.
//
// Design: one thread per point, kPoints points per block. Each thread runs,
// branch after branch, the forward and the hand-written adjoint
// (psi_lap_train_vjp_plain, transliterated; train.cuh branch_stage). The
// cotangents of a branch's output are dpsi g and dlap g (times P for the
// mirrored branch), known before the forward, so a branch needs nothing of
// the other. Weight gradients are sums over points; per block they are
// reduced in a FIXED order with no atomics, so two launches give the same
// bits (the trainer's best tracking compares losses across steps). For
// that, each thread stages its first-layer stacks, its second-layer
// cotangent stacks and its other per-weight terms in shared memory; after a
// barrier each output weight is summed by one thread over the block's points
// in order: w2 and b2 after each branch (into sacc), the rest once at the
// end. Rows of the staging buffers are padded to kPoints + 1 so that both
// the per-thread writes and the per-weight reads are free of bank
// conflicts. The buffers take (H^2 + 5H + 1) + (H^2 + H) + (12 H + 1)
// (kPoints + 1) values: at 64 points a block, 105 KB in float64 at H = 16
// and 218 KB at H = 32 (under the 227 KB a block may opt in to). Lanes past
// n evaluate the finite pad point with zero cotangents, so every term they
// stage is exactly 0.

#include "train.cuh"

using namespace trn;

namespace {

constexpr int kPoints = 64;       // threads (points) per block
constexpr int kLd = kPoints + 1;  // padded row stride of the staging buffers

template <int H>
constexpr int smem_elems() {
  return Layout<H>::SIZE + H * H + H + (12 * H + 1) * kLd;
}

template <typename T, int H>
__global__ void __launch_bounds__(kPoints)
    train_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     const T* __restrict__ z, const T* __restrict__ r,
                     const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ g, const T* __restrict__ w,
                     const T* __restrict__ dpsi, const T* __restrict__ dlap,
                     T* __restrict__ da_out, T* __restrict__ db_out,
                     T* __restrict__ dg_out, T* __restrict__ partials, int n,
                     T psym, T ry, T rz) {
  using L = Layout<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sacc = sw + L::SIZE;        // [H^2 + H] w2, b2 sums over both branches
  T* sA = sacc + H * H + H;      // [4H][kLd] first-layer stacks
  T* sG = sA + 4 * H * kLd;      // [4H][kLd] second-layer cotangent stacks
  T* sD = sG + 4 * H * kLd;      // [H][kLd]  output-weight terms
  T* sE = sD + H * kLd;          // [3H][kLd] first-layer terms
  T* sC = sE + 3 * H * kLd;      // [kLd]     value cotangents (ob)
  for (int i = threadIdx.x; i < L::SIZE; i += kPoints) sw[i] = w[i];
  __syncthreads();

  const int tid = threadIdx.x;
  const int p = blockIdx.x * kPoints + tid;
  const bool live = p < n;
  const T one = T(1);
  const T xv = live ? x[p] : one, yv = live ? y[p] : one;
  const T zv = live ? z[p] : one, rv = live ? r[p] : one;
  const T av = live ? a[p] : one, bv = live ? b[p] : one;
  const T gv = live ? g[p] : one;
  const T gpsi = live ? dpsi[p] : T(0);
  const T glap = live ? dlap[p] : T(0);
  // cotangents of the gated network's (value, laplacian)
  const T cv = gpsi * gv;
  const T cl = glap * gv;

  T nnv = sw[L::OB], nnl = T(0), da = T(0), db = T(0);
  for (int m = 0; m < 2; ++m) {
    const T pb = m == 0 ? one : psym;
    Env<T> e;
    branch_envelopes(xv, yv, zv, rv, ry, rz, av, m == 1, e);
    T ov, ol;
    da += branch_stage<T, H, kLd>(sw, e, av, pb * cv, pb * cl, tid, m == 0,
                                  sA, sG, sD, sE, ov, ol);
    nnv += pb * ov;
    nnl += pb * ol;
    __syncthreads();
    for (int o = tid; o < H * H + H; o += kPoints) {
      const T acc = reduce_layer2<T, H, kPoints, kLd>(o, sA, sG);
      sacc[o] = m == 0 ? acc : sacc[o] + acc;
    }
    __syncthreads();
  }
  Env<T> ep;
  branch_envelopes(xv, yv, zv, rv, ry, rz, av, false, ep);
  gz_adjoint(av, bv, psym, ep, gpsi, glap, da, db);
  if (live) {
    da_out[p] = da;
    db_out[p] = db;
    dg_out[p] = gpsi * nnv + glap * nnl;
  }
  sC[tid] = cv;
  __syncthreads();
  T* part = partials + static_cast<size_t>(blockIdx.x) * L::SIZE;
  for (int o = tid; o < L::SIZE; o += kPoints)
    part[o] = reduce_packed<T, H, kPoints, kLd>(o, sacc, sD, sE, sC);
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* g, const void* w,
                   const void* dpsi, const void* dlap, void* da, void* db,
                   void* dg, void* partials, int n, int psym, double ry,
                   double rz, cudaStream_t stream) {
  const int blocks = (n + kPoints - 1) / kPoints;
  const size_t smem = sizeof(T) * smem_elems<H>();
  cudaError_t err = cudaFuncSetAttribute(
      train_bwd_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  train_bwd_kernel<T, H><<<blocks, kPoints, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<const T*>(dpsi), static_cast<const T*>(dlap),
      static_cast<T*>(da), static_cast<T*>(db), static_cast<T*>(dg),
      static_cast<T*>(partials), n, T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* g, const void* w,
             const void* dpsi, const void* dlap, void* da, void* db, void* dg,
             void* partials, int n, int hidden, int psym, double ry,
             double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRAIN_BWD_CASE(HH)                                                  \
  case HH:                                                                  \
    return launch<T, HH>(x, y, z, r, a, b, g, w, dpsi, dlap, da, db, dg,    \
                         partials, n, psym, ry, rz, s);
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

}  // namespace

extern "C" int train_bwd_points_per_block() { return kPoints; }

extern "C" int train_bwd_f64(const void* x, const void* y, const void* z,
                             const void* r, const void* a, const void* b,
                             const void* g, const void* w, const void* dpsi,
                             const void* dlap, void* da, void* db, void* dg,
                             void* partials, int n, int hidden, int psym,
                             double ry, double rz, void* stream) {
  return dispatch<double>(x, y, z, r, a, b, g, w, dpsi, dlap, da, db, dg,
                          partials, n, hidden, psym, ry, rz, stream);
}

extern "C" int train_bwd_f32(const void* x, const void* y, const void* z,
                             const void* r, const void* a, const void* b,
                             const void* g, const void* w, const void* dpsi,
                             const void* dlap, void* da, void* db, void* dg,
                             void* partials, int n, int hidden, int psym,
                             double ry, double rz, void* stream) {
  return dispatch<float>(x, y, z, r, a, b, g, w, dpsi, dlap, da, db, dg,
                         partials, n, hidden, psym, ry, rz, stream);
}

extern "C" const char* train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
