// K3: forward-only fused (psi, lap psi) of the reference-parity symmetric
// model (fixed exponent 1, 2-feature base, LCAO physics part).
//
// Replaces: pinn_for_quantum_wavefunction_surfaces_tpu/ops/pallas_residual.py
//   psi_lap_pallas (the pl.pallas_call at :200, body _make_kernel :96),
//   which evaluates the kernel on (8, 128) VMEM tiles padded with the point
//   (1, 1, 1; R = 1).
//
// Per point:
//   psi     = g(R) (b+ + P b- + ob) + e^{-r1} + P e^{-r2}
//   lap psi = g(R) (lap b+ + P lap b-) + e^{-r1} (1 - 2/r1)
//             + P e^{-r2} (1 - 2/r2)
// where b+- are the two weight-shared sigmoid-MLP branches 2 -> H -> H -> 1
// on the envelopes e^{-r1}, e^{-r2} (b- at the geometry mirrored at
// x -> -x), ob the output bias (0 in the ungerade sector, passed so by the
// wrapper) and g(R) the 1 -> Hg -> 1 sigmoid gate, evaluated here per point
// as the TPU kernel does. Mathematically this is K2-fwd (train_fwd.cu) with
// a = 1, b = 0 and the gate moved into the kernel: 4 values read per point
// instead of 7.
//
// What bounds it on an H100: arithmetic. Per point it reads 4 values and
// writes 2 (48 bytes in float64) and does 16 H^2 + 104 H + 8 Hg + 101
// floating-point operations (5.9k at H = 16, Hg = 10; chip_smoke.py,
// residual_fwd_ops), each transcendental counted once: ~120 flop/byte,
// above the card's float64 ridge point of 20. The 80^3 quadrature grid of
// `cli energy` (512 000 points) is ~3 GFLOP a call, ~45 us at the peak.
//
// Design: one thread per point; nothing but the two outputs touches device
// memory. The H^2 + 5H + 1 + 3Hg + 1 weights are staged once per block in
// (dynamic) shared memory, where every read is a broadcast. Each branch
// keeps its H first-layer 4-stacks in registers (the span{u1, u2}
// formulation of train.cuh: value, two gradient coefficients, laplacian,
// one fewer than the TPU kernel's 5-stack; fully unrolled, H is a template
// parameter); the gate loops over Hg at run time. Lanes past n evaluate the
// finite pad point and store nothing.

#include "train.cuh"

using namespace trn;

namespace {

constexpr int kThreads = 128;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    residual_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        const T* __restrict__ z, const T* __restrict__ r,
                        const T* __restrict__ w, T* __restrict__ psi,
                        T* __restrict__ lap, int n, int hg, T psym, T ry,
                        T rz) {
  using L = Layout<H>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sw = reinterpret_cast<T*>(smem);
  const int nw = L::SIZE + 3 * hg + 1;
  for (int i = threadIdx.x; i < nw; i += kThreads) sw[i] = w[i];
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < n;
  const T one = T(1);
  const T xv = live ? x[p] : one, yv = live ? y[p] : one;
  const T zv = live ? z[p] : one, rv = live ? r[p] : one;

  Env<T> ep, em;
  branch_envelopes(xv, yv, zv, rv, ry, rz, one, false, ep);
  branch_envelopes(xv, yv, zv, rv, ry, rz, one, true, em);
  T vp, lp, vm, lm;
  branch_fwd<T, H>(sw, ep, vp, lp);
  branch_fwd<T, H>(sw, em, vm, lm);
  const T nnv = vp + psym * vm + sw[L::OB];
  const T nnl = lp + psym * lm;

  // gate(R): gw1 (Hg) | gb1 (Hg) | gw2 (Hg) | gb2 (1) after the MLP
  const T* gw1 = sw + L::SIZE;
  const T* gb1 = gw1 + hg;
  const T* gw2 = gb1 + hg;
  T gate = T(0);
  for (int j = 0; j < hg; ++j) gate += m_sigmoid(rv * gw1[j] + gb1[j]) * gw2[j];
  gate += gw2[hg];

  if (live) {
    psi[p] = nnv * gate + ep.f1 + psym * ep.f2;
    lap[p] = nnl * gate + ep.l1 + psym * ep.l2;
  }
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* w, void* psi, void* lap, int n, int psym,
                   int hg, double ry, double rz, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(T) * (Layout<H>::SIZE + 3 * hg + 1);
  residual_fwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(w), static_cast<T*>(psi), static_cast<T*>(lap),
      n, hg, T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* w, void* psi, void* lap, int n, int hidden, int psym,
             int hg, double ry, double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RESIDUAL_FWD_CASE(HH) \
  case HH:                    \
    return launch<T, HH>(x, y, z, r, w, psi, lap, n, psym, hg, ry, rz, s);
  switch (hidden) {
    RESIDUAL_FWD_CASE(4)
    RESIDUAL_FWD_CASE(8)
    RESIDUAL_FWD_CASE(16)
    RESIDUAL_FWD_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RESIDUAL_FWD_CASE
}

}  // namespace

extern "C" int residual_fwd_f64(const void* x, const void* y, const void* z,
                                const void* r, const void* w, void* psi,
                                void* lap, int n, int hidden, int psym,
                                int hidden_gate, double ry, double rz,
                                void* stream) {
  return dispatch<double>(x, y, z, r, w, psi, lap, n, hidden, psym,
                          hidden_gate, ry, rz, stream);
}

extern "C" int residual_fwd_f32(const void* x, const void* y, const void* z,
                                const void* r, const void* w, void* psi,
                                void* lap, int n, int hidden, int psym,
                                int hidden_gate, double ry, double rz,
                                void* stream) {
  return dispatch<float>(x, y, z, r, w, psi, lap, n, hidden, psym,
                         hidden_gate, ry, rz, stream);
}

extern "C" const char* train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
