// K2 forward: fused (psi, lap psi) of the symmetric ansatz family.
//
// Replaces: pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_train.py
//   fwd_kernel (the pl.pallas_call in run_fwd), which evaluates _core on
//   (32, 128) VMEM tiles padded with the point (1, 1, 1; R = 1) and
//   a = b = g = 1.
//
// Per point: two weight-shared sigmoid-MLP branches 2 -> H -> H -> 1 (the
// second mirrored at x -> -x) on the envelope stacks of e^{-a r1},
// e^{-a r2}, combined as b+ + P b- + ob and gated by g, plus the
// Guillemin-Zener pair (train.cuh).
//
// What bounds it on an H100: arithmetic. Per point it reads 7 values and
// writes 2 (72 bytes in float64) and does 16 H^2 + 104 H + 129
// floating-point operations (5.9k at H = 16; chip_smoke.py, train_fwd_ops),
// each transcendental counted once: ~80 flop/byte, above the card's float64
// ridge point (67 TFLOP/s over 3.35 TB/s = 20 flop/byte). At the training
// batch of 100 000 points the call is ~0.6 GFLOP, about 9 us at the peak,
// the order of a launch.
//
// Design: one thread per point; nothing but the two outputs touches device
// memory. The H^2 + 5H + 1 weights are loaded once per block into shared
// memory, where every read is a broadcast; each branch keeps its H
// first-layer 4-stacks in registers (fully unrolled, H is a template
// parameter). Lanes past n evaluate the finite pad point and store nothing.

#include "train.cuh"

using namespace trn;

namespace {

constexpr int kThreads = 128;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    train_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     const T* __restrict__ z, const T* __restrict__ r,
                     const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ g, const T* __restrict__ w,
                     T* __restrict__ psi, T* __restrict__ lap, int n, T psym,
                     T ry, T rz) {
  using L = Layout<H>;
  __shared__ T sw[L::SIZE];
  for (int i = threadIdx.x; i < L::SIZE; i += kThreads) sw[i] = w[i];
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < n;
  const T one = T(1);
  const T xv = live ? x[p] : one, yv = live ? y[p] : one;
  const T zv = live ? z[p] : one, rv = live ? r[p] : one;
  const T av = live ? a[p] : one, bv = live ? b[p] : one;
  const T gv = live ? g[p] : one;

  Env<T> ep, em;
  branch_envelopes(xv, yv, zv, rv, ry, rz, av, false, ep);
  branch_envelopes(xv, yv, zv, rv, ry, rz, av, true, em);
  T vp, lp, vm, lm;
  branch_fwd<T, H>(sw, ep, vp, lp);
  branch_fwd<T, H>(sw, em, vm, lm);
  const T nnv = vp + psym * vm + sw[L::OB];
  const T nnl = lp + psym * lm;
  const GZ<T> q = gz(av, bv, ep);
  if (live) {
    psi[p] = nnv * gv + q.v1 + psym * q.v2;
    lap[p] = nnl * gv + q.v1 * q.s1 + psym * (q.v2 * q.s2);
  }
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* g, const void* w,
                   void* psi, void* lap, int n, int psym, double ry, double rz,
                   cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  train_fwd_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<T*>(psi), static_cast<T*>(lap), n, T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* g, const void* w,
             void* psi, void* lap, int n, int hidden, int psym, double ry,
             double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRAIN_FWD_CASE(HH) \
  case HH:                 \
    return launch<T, HH>(x, y, z, r, a, b, g, w, psi, lap, n, psym, ry, rz, s);
  switch (hidden) {
    TRAIN_FWD_CASE(4)
    TRAIN_FWD_CASE(8)
    TRAIN_FWD_CASE(16)
    TRAIN_FWD_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRAIN_FWD_CASE
}

}  // namespace

extern "C" int train_fwd_f64(const void* x, const void* y, const void* z,
                             const void* r, const void* a, const void* b,
                             const void* g, const void* w, void* psi,
                             void* lap, int n, int hidden, int psym, double ry,
                             double rz, void* stream) {
  return dispatch<double>(x, y, z, r, a, b, g, w, psi, lap, n, hidden, psym,
                          ry, rz, stream);
}

extern "C" int train_fwd_f32(const void* x, const void* y, const void* z,
                             const void* r, const void* a, const void* b,
                             const void* g, const void* w, void* psi,
                             void* lap, int n, int hidden, int psym, double ry,
                             double rz, void* stream) {
  return dispatch<float>(x, y, z, r, a, b, g, w, psi, lap, n, hidden, psym,
                         ry, rz, stream);
}

extern "C" const char* train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
