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
// as the TPU kernel does. Mathematically this is K2-fwd with a = 1, b = 0
// and the gate moved into the kernel: 4 values read per point instead of 7.
// So K3 is K2-fwd's two kernel templates (train_fwd.cuh) instantiated with
// the GateSource policy; only the launches live here.
//
// What bounds it on an H100: arithmetic. Per point it reads 4 values and
// writes 2 (48 bytes in float64) and does 16 H^2 + 104 H + 8 Hg + 101
// floating-point operations (5.9k at H = 16, Hg = 10; chip_smoke.py,
// residual_fwd_ops), each transcendental counted once: ~120 flop/byte,
// above the card's float64 ridge point of 20. The 80^3 quadrature grid of
// `cli energy` (512 000 points) is ~3 GFLOP a call. On an H100 SXM at 700 W
// the kernel runs at ~8x its operation bound in float64 and ~3x in float32.
//
// Design, by type:
// - float32: one thread a point, 128 a block; the gate's 3 Hg + 1 weights in
//   dynamic shared memory beside the MLP's.
// - float64: tiles of 32 points (16 at H = 32) on blocks of 256 threads,
//   the second layer on the float64 tensor cores (train_tile.cuh); the gate
//   runs beside the first layer on all 256 threads. Its weights, the
//   points' R and the pairs' gate sums add 3 Hg + 1 + 3 P values to K2-fwd's
//   shared memory (gate_tile_smem_elems). One block a tile, as K2-fwd
//   launches.
// - bfloat16 (residual_fwd_bf16): the float32 kernel on bfloat16 tensors,
//   loaded into float and rounded once at the store (train_fwd.cuh).
// One thread a point with both branches fully unrolled in registers spilled
// 2.3 KB in float64 at H = 16; the tiles spill nothing at any width.

#include <algorithm>

#include "train_fwd.cuh"

using namespace trn;

namespace {

// Shared memory (bytes) of a launch, set as the kernel's limit where it
// passes the 48 KB a block gets without opting in. S: the tensors' storage
// type; the gate's weights are staged in the compute type.
template <typename S, int H>
cudaError_t prepare(int hg, size_t* smem) {
  if constexpr (std::is_same<S, double>::value) {
    *smem = sizeof(S) * gate_tile_smem_elems<H>(hg);
    return cudaFuncSetAttribute(train_fwd_tile_kernel<S, H, GateSource>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  } else {
    *smem = sizeof(kern::compute_t<S>) * (3 * hg + 1);
    return cudaSuccess;
  }
}

template <typename S, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* w, void* psi, void* lap, int n, int psym,
                   int hg, double ry, double rz, cudaStream_t stream) {
  using T = kern::compute_t<S>;
  size_t smem;
  cudaError_t err = prepare<S, H>(hg, &smem);
  if (err != cudaSuccess) return err;
  const S* px = static_cast<const S*>(x);
  const S* py = static_cast<const S*>(y);
  const S* pz = static_cast<const S*>(z);
  const S* pr = static_cast<const S*>(r);
  const S* pw = static_cast<const S*>(w);
  if constexpr (std::is_same<S, double>::value) {
    const int blocks = std::max(1, (n + Tile<H>::P - 1) / Tile<H>::P);
    train_fwd_tile_kernel<S, H, GateSource>
        <<<blocks, kTileThreads, smem, stream>>>(
            px, py, pz, pr, nullptr, nullptr, nullptr, pw,
            static_cast<S*>(psi), static_cast<S*>(lap), n, T(psym), T(ry),
            T(rz), hg);
  } else {
    const int blocks = std::max(1, (n + kPointThreads - 1) / kPointThreads);
    train_fwd_point_kernel<S, H, GateSource>
        <<<blocks, kPointThreads, smem, stream>>>(
            px, py, pz, pr, nullptr, nullptr, nullptr, pw,
            static_cast<S*>(psi), static_cast<S*>(lap), n, T(psym), T(ry),
            T(rz), hg);
  }
  return cudaGetLastError();
}

template <typename S>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* w, void* psi, void* lap, int n, int hidden, int psym,
             int hg, double ry, double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RESIDUAL_FWD_CASE(HH) \
  case HH:                    \
    return launch<S, HH>(x, y, z, r, w, psi, lap, n, psym, hg, ry, rz, s);
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

// Resident blocks per SM at this gate width, and the launch's shared memory.
template <typename S, int H>
int occupancy(int hg, int* smem_bytes) {
  size_t smem;
  if (prepare<S, H>(hg, &smem) != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err;
  if constexpr (std::is_same<S, double>::value)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_fwd_tile_kernel<S, H, GateSource>, kTileThreads, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_fwd_point_kernel<S, H, GateSource>, kPointThreads,
        smem);
  if (err != cudaSuccess) return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
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

extern "C" int residual_fwd_bf16(const void* x, const void* y, const void* z,
                                 const void* r, const void* w, void* psi,
                                 void* lap, int n, int hidden, int psym,
                                 int hidden_gate, double ry, double rz,
                                 void* stream) {
  return dispatch<__nv_bfloat16>(x, y, z, r, w, psi, lap, n, hidden, psym,
                                 hidden_gate, ry, rz, stream);
}

// Resident blocks per SM of the instantiation of type code `type`
// (kern::TypeCode) at this width and gate width, and its shared memory per
// block in *smem_bytes; -1 on error.
extern "C" int residual_fwd_occupancy(int hidden, int hidden_gate, int type,
                                      int* smem_bytes) {
#define RESIDUAL_FWD_OCC(HH)                                               \
  case HH:                                                                 \
    return type == kern::kF64 ? occupancy<double, HH>(hidden_gate, smem_bytes) \
           : type == kern::kBF16                                           \
               ? occupancy<__nv_bfloat16, HH>(hidden_gate, smem_bytes)     \
               : occupancy<float, HH>(hidden_gate, smem_bytes);
  switch (hidden) {
    RESIDUAL_FWD_OCC(4)
    RESIDUAL_FWD_OCC(8)
    RESIDUAL_FWD_OCC(16)
    RESIDUAL_FWD_OCC(32)
    default:
      return -1;
  }
#undef RESIDUAL_FWD_OCC
}

extern "C" const char* train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
