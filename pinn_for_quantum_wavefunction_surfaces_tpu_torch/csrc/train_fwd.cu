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
// ridge point (67 TFLOP/s over 3.35 TB/s = 20 flop/byte). Half of the
// operations are the second layer's products, 8 H^2 a point; the 4 H
// sigmoids (an exp and a divide each) and the barriers of a tile come next.
//
// Design, by type (the kernel templates of train_fwd.cuh, instantiated here
// with the ReadSource policy: a, b and g read per point):
// - float32: one thread a point, the two branches one after the other and
//   the second layer's units in a rolled loop: 160 registers, 3 blocks of 4
//   warps an SM, no spills (the unrolled one-thread-a-point kernel spilled
//   668 B at H = 16); ~3x its operation bound, set by the rate of FMA and
//   shared-load instructions of the per-point products.
// - float64 (train_tile.cuh): one thread a point spilled (3.1 KB at H = 16)
//   and left the second layer to scalar FMAs at half the tensor-core rate.
//   Tiles of 32 points (16 at H = 32) on blocks of 256 threads, the second
//   layer's L = A W2 on the float64 tensor cores; one block a tile; 64
//   registers and 55 KB of shared memory at H = 16, 4 blocks of 8 warps an
//   SM, no spills; ~8x its operation bound on an H100 SXM at 700 W (the
//   float64 sigmoids and the 4 barriers a tile; not measured).
// - bfloat16 (train_fwd_bf16): the float32 kernel on bfloat16 tensors,
//   loaded into float and rounded once at the store (train_fwd.cuh): the
//   same operations on half the bytes.

#include "rheads.cuh"
#include "train_fwd.cuh"

using namespace trn;

namespace {

// Shared memory (bytes) of a launch, set as the kernel's limit. S: the
// tensors' storage type; the float64 build runs on tiles, the float32 and
// bfloat16 builds one thread a point.
template <typename S, int H>
cudaError_t prepare(size_t* smem) {
  if constexpr (std::is_same<S, double>::value) {
    *smem = sizeof(S) * tile_smem_elems<H>(1);
    return cudaFuncSetAttribute(train_fwd_tile_kernel<S, H, ReadSource>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  } else {
    *smem = 0;
    return cudaSuccess;
  }
}

template <typename T, int H>
constexpr int points_per_tile() {
  return std::is_same<T, double>::value ? Tile<H>::P : kPointThreads;
}

template <typename S, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* g, const void* w,
                   void* psi, void* lap, int n, int psym, double ry, double rz,
                   cudaStream_t stream) {
  using T = kern::compute_t<S>;
  size_t smem;
  cudaError_t err = prepare<S, H>(&smem);
  if (err != cudaSuccess) return err;
  constexpr int per = points_per_tile<S, H>();
  const int blocks = n > 0 ? (n + per - 1) / per : 1;
  const S* px = static_cast<const S*>(x);
  const S* py = static_cast<const S*>(y);
  const S* pz = static_cast<const S*>(z);
  const S* pr = static_cast<const S*>(r);
  const S* pa = static_cast<const S*>(a);
  const S* pb = static_cast<const S*>(b);
  const S* pg = static_cast<const S*>(g);
  const S* pw = static_cast<const S*>(w);
  if constexpr (std::is_same<S, double>::value)
    train_fwd_tile_kernel<S, H, ReadSource>
        <<<blocks, kTileThreads, smem, stream>>>(
            px, py, pz, pr, pa, pb, pg, pw, static_cast<S*>(psi),
            static_cast<S*>(lap), n, T(psym), T(ry), T(rz), 0);
  else
    train_fwd_point_kernel<S, H, ReadSource>
        <<<blocks, kPointThreads, 0, stream>>>(
            px, py, pz, pr, pa, pb, pg, pw, static_cast<S*>(psi),
            static_cast<S*>(lap), n, T(psym), T(ry), T(rz), 0);
  return cudaGetLastError();
}

// Resident blocks per SM and shared memory per block (bytes).
template <typename S, int H>
int occupancy(int* smem_bytes) {
  size_t smem;
  if (prepare<S, H>(&smem) != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err;
  if constexpr (std::is_same<S, double>::value)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_fwd_tile_kernel<S, H, ReadSource>, kTileThreads,
        smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_fwd_point_kernel<S, H, ReadSource>, kPointThreads,
        smem);
  if (err != cudaSuccess) return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

template <typename S>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* g, const void* w,
             void* psi, void* lap, int n, int hidden, int psym, double ry,
             double rz, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRAIN_FWD_CASE(HH) \
  case HH:                 \
    return launch<S, HH>(x, y, z, r, a, b, g, w, psi, lap, n, psym, ry, rz, s);
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

extern "C" int train_fwd_bf16(const void* x, const void* y, const void* z,
                              const void* r, const void* a, const void* b,
                              const void* g, const void* w, void* psi,
                              void* lap, int n, int hidden, int psym,
                              double ry, double rz, void* stream) {
  return dispatch<__nv_bfloat16>(x, y, z, r, a, b, g, w, psi, lap, n, hidden,
                                 psym, ry, rz, stream);
}

// Points a block takes at a time in the build of type code `type`
// (kern::TypeCode; bfloat16 as float32) (the wrapper's n_tiles must
// agree), or -1.
extern "C" int train_fwd_points_per_tile(int hidden, int type) {
#define TRAIN_FWD_TILE(HH)                            \
  case HH:                                            \
    return type == kern::kF64 ? points_per_tile<double, HH>() \
                              : points_per_tile<float, HH>();
  switch (hidden) {
    TRAIN_FWD_TILE(4)
    TRAIN_FWD_TILE(8)
    TRAIN_FWD_TILE(16)
    TRAIN_FWD_TILE(32)
    default:
      return -1;
  }
#undef TRAIN_FWD_TILE
}

// Resident blocks per SM of the instantiation of type code `type`
// (kern::TypeCode) at this width, and its shared memory per block in
// *smem_bytes; -1 on error.
extern "C" int train_fwd_occupancy(int hidden, int type, int* smem_bytes) {
#define TRAIN_FWD_OCC(HH)                                               \
  case HH:                                                              \
    return type == kern::kF64    ? occupancy<double, HH>(smem_bytes)    \
           : type == kern::kBF16 ? occupancy<__nv_bfloat16, HH>(smem_bytes) \
                                 : occupancy<float, HH>(smem_bytes);
  switch (hidden) {
    TRAIN_FWD_OCC(4)
    TRAIN_FWD_OCC(8)
    TRAIN_FWD_OCC(16)
    TRAIN_FWD_OCC(32)
    default:
      return -1;
  }
#undef TRAIN_FWD_OCC
}

// ---------------------------------------------------------------------------
// The R-heads forward (rheads.cuh): E, a, b, g at each point's R; one block
// a tile of rhd::kThreads points. hg, ha, hb: the rank-1 heads' widths (0:
// no alpha or beta head).

namespace {

template <typename S, int HE>
cudaError_t rheads_prepare(int hg, int ha, int hb, size_t* smem) {
  *smem = sizeof(kern::compute_t<S>) * rhd::heads_of<HE>(hg, ha, hb).size;
  return cudaFuncSetAttribute(rhd::rheads_fwd_kernel<S, HE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename S, int HE>
cudaError_t rheads_launch(const void* r, const void* w, void* e, void* a,
                          void* b, void* g, int n, int psym, int hg, int ha,
                          int hb, cudaStream_t stream) {
  using T = kern::compute_t<S>;
  size_t smem;
  cudaError_t err = rheads_prepare<S, HE>(hg, ha, hb, &smem);
  if (err != cudaSuccess) return err;
  const int blocks = n > 0 ? (n + rhd::kThreads - 1) / rhd::kThreads : 1;
  rhd::rheads_fwd_kernel<S, HE><<<blocks, rhd::kThreads, smem, stream>>>(
      static_cast<const S*>(r), static_cast<const S*>(w), static_cast<S*>(e),
      static_cast<S*>(a), static_cast<S*>(b), static_cast<S*>(g), n, hg, ha,
      hb, T(psym));
  return cudaGetLastError();
}

template <typename S, int HE>
int rheads_occupancy(int hr, int* smem_bytes) {
  size_t smem;
  if (rheads_prepare<S, HE>(hr, hr, hr, &smem) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, rhd::rheads_fwd_kernel<S, HE>, rhd::kThreads, smem) !=
      cudaSuccess)
    return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

template <typename S>
int rheads_dispatch(const void* r, const void* w, void* e, void* a, void* b,
                    void* g, int n, int he, int psym, int hg, int ha, int hb,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hg < 1 || ha < 0 || hb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define RHEADS_FWD_CASE(HH) \
  case HH:                  \
    return rheads_launch<S, HH>(r, w, e, a, b, g, n, psym, hg, ha, hb, s);
  switch (he) {
    RHEADS_FWD_CASE(4)
    RHEADS_FWD_CASE(8)
    RHEADS_FWD_CASE(16)
    RHEADS_FWD_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RHEADS_FWD_CASE
}

}  // namespace

extern "C" int rheads_fwd_f64(const void* r, const void* w, void* e, void* a,
                              void* b, void* g, int n, int he, int psym,
                              int hg, int ha, int hb, void* stream) {
  return rheads_dispatch<double>(r, w, e, a, b, g, n, he, psym, hg, ha, hb,
                                 stream);
}

extern "C" int rheads_fwd_f32(const void* r, const void* w, void* e, void* a,
                              void* b, void* g, int n, int he, int psym,
                              int hg, int ha, int hb, void* stream) {
  return rheads_dispatch<float>(r, w, e, a, b, g, n, he, psym, hg, ha, hb,
                                stream);
}

extern "C" int rheads_fwd_bf16(const void* r, const void* w, void* e,
                               void* a, void* b, void* g, int n, int he,
                               int psym, int hg, int ha, int hb,
                               void* stream) {
  return rheads_dispatch<__nv_bfloat16>(r, w, e, a, b, g, n, he, psym, hg,
                                        ha, hb, stream);
}

// Resident blocks per SM at E width he with every rank-1 head hr units
// wide, and the shared memory per block in *smem_bytes; -1 on error.
extern "C" int rheads_fwd_occupancy(int he, int hr, int type,
                                    int* smem_bytes) {
#define RHEADS_FWD_OCC(HH)                                                  \
  case HH:                                                                  \
    return type == kern::kF64 ? rheads_occupancy<double, HH>(hr, smem_bytes) \
           : type == kern::kBF16                                            \
               ? rheads_occupancy<__nv_bfloat16, HH>(hr, smem_bytes)        \
               : rheads_occupancy<float, HH>(hr, smem_bytes);
  switch (he) {
    RHEADS_FWD_OCC(4)
    RHEADS_FWD_OCC(8)
    RHEADS_FWD_OCC(16)
    RHEADS_FWD_OCC(32)
    default:
      return -1;
  }
#undef RHEADS_FWD_OCC
}

extern "C" const char* train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
