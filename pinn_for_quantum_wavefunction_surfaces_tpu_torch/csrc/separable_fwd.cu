// K1 forward: fused (psi, lap psi) of the separable-spheroidal family.
//
// Replaces: pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_separable.py
//   fwd_kernel (the pl.pallas_call in run_fwd), which evaluates _core on
//   (32, 128) VMEM tiles padded with the point (1, 1, 1; R = 1).
//
// What bounds it on an H100: arithmetic. Per point it reads 6 values and
// writes 2 (64 bytes in float64) but does about 2 (6 H^2 + 29 H + 1) + 115
// floating-point operations (~4.1k at H = 16) and 4 H + 6 transcendentals:
// ~64 flop/byte, above the card's float64 ridge point (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte). At the flagship batch (164 502 points) the
// whole call is ~0.7 GFLOP, so launch latency is of the same order.
//
// Design: one thread per point, nothing but the two outputs touches device
// memory. The 2 (H^2 + 5H + 1) weights are loaded once per block into shared
// memory, where every read is a broadcast; the H first-layer triples of each
// MLP stay in registers (fully unrolled, H is a template parameter). Lanes
// past n evaluate the finite pad point and store nothing.

#include "separable.cuh"

using namespace sep;

namespace {

constexpr int kThreads = 128;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    separable_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ z, const T* __restrict__ r,
                         const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ w, T* __restrict__ psi,
                         T* __restrict__ lap, int n, T psym, T ry, T rz) {
  constexpr int WS = Layout<H>::SIZE;
  __shared__ T sw[2 * WS];
  for (int i = threadIdx.x; i < 2 * WS; i += kThreads) sw[i] = w[i];
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < n;
  const T one = T(1);
  Point<T> pt;
  point_setup(live ? x[p] : one, live ? y[p] : one, live ? z[p] : one,
              live ? r[p] : one, ry, rz, pt);
  const T av = live ? a[p] : one;
  const T bv = live ? b[p] : one;

  T l0, l1, l2, m0, m1, m2;
  mlp_fwd<T, H>(sw, pt.t0, pt.cf, l0, l1, l2);
  mlp_fwd<T, H>(sw + WS, pt.e0, pt.cf, m0, m1, m2);
  const GZ<T> g = gz(av, bv, psym, pt);
  Top<T> st;
  top_forward(l0, l1, l2, m0, m1, m2, g, pt, st);
  if (live) {
    psi[p] = st.psi;
    lap[p] = st.lap;
  }
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* w, void* psi,
                   void* lap, int n, int psym, double ry, double rz,
                   cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  separable_fwd_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(w), static_cast<T*>(psi), static_cast<T*>(lap), n,
      T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* w, void* psi, void* lap,
             int n, int hidden, int psym, double ry, double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEP_FWD_CASE(HH) \
  case HH:               \
    return launch<T, HH>(x, y, z, r, a, b, w, psi, lap, n, psym, ry, rz, s);
  switch (hidden) {
    SEP_FWD_CASE(4)
    SEP_FWD_CASE(8)
    SEP_FWD_CASE(16)
    SEP_FWD_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SEP_FWD_CASE
}

}  // namespace

extern "C" int separable_fwd_f64(const void* x, const void* y, const void* z,
                                 const void* r, const void* a, const void* b,
                                 const void* w, void* psi, void* lap, int n,
                                 int hidden, int psym, double ry, double rz,
                                 void* stream) {
  return dispatch<double>(x, y, z, r, a, b, w, psi, lap, n, hidden, psym, ry,
                          rz, stream);
}

extern "C" int separable_fwd_f32(const void* x, const void* y, const void* z,
                                 const void* r, const void* a, const void* b,
                                 const void* w, void* psi, void* lap, int n,
                                 int hidden, int psym, double ry, double rz,
                                 void* stream) {
  return dispatch<float>(x, y, z, r, a, b, w, psi, lap, n, hidden, psym, ry,
                         rz, stream);
}

extern "C" const char* separable_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
