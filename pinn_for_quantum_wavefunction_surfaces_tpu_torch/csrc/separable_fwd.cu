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
// 3.35 TB/s = 20 flop/byte); in float32, 32 bytes a point, ~128 flop/byte
// against the same ridge. Two thirds of the operations are the second
// layers' products, 3 H^2 multiply-adds a point and MLP; the float64 tanh
// of the 4 H units is a software routine of tens of instructions each.
//
// Design, by type (separable.cuh):
// - float64 (separable_fwd_kernel): a block of 256 threads takes one tile
//   of P points (32 at H = 16). The first P threads compute the points'
//   geometry and GZ pair, one a point, and later the bounded correction
//   and product rule; in between, 8 threads a point evaluate the MLPs,
//   whose tanh units they share, and each MLP's second layer runs as the
//   tile product [3P, H] x [H, H] on the float64 tensor cores instead of
//   3 H^2 scalar multiply-adds a point. Shared memory holds the weights,
//   two [3P, H] tiles and the per-point vectors (32 KB at H = 16), so
//   several blocks are resident on an SM. Measured (chip_smoke.py phase 6)
//   the kernel moved little against the one-thread-a-point design: the
//   float64 tanh of the 4 H units and the tile's barriers set its time.
// - float32 (separable_fwd_point_kernel): one thread a point from its
//   inputs to psi and lap psi, 128 points a block, one block a tile; no
//   barrier but the one after the weights are staged. Both MLPs' weights
//   sit in static shared memory (2.7 KB at H = 16), where every read is a
//   broadcast; a point's first-layer triples stay in registers and the
//   second layer takes four units at a time, one 16-byte read of w2 for 12
//   multiply-adds (mlp_point_forward). 116 registers at H = 16, 4 blocks
//   of 4 warps an SM, no spills. Measured on an H100 SXM at 700 W
//   (chip_smoke.py --k1-times): 2.3x its operation bound at 1 048 576
//   points, 2.7x at the flagship's 164 502 (the last, partial wave of
//   blocks). What bounds it is the issue rate of its instructions: beside
//   the 6 H^2 product FMAs a point, the 4 H tanhf (an EX2, an RCP and a
//   select of about a dozen instructions each), the units' epilogues and
//   the point's geometry. A tanh of five instructions measured barely
//   faster and is not used (its error near 0 is absolute, not relative).
// - bfloat16 (separable_fwd_bf16): the float32 kernel on bfloat16 tensors.
//   The points, heads and weights are loaded into float and psi and lap psi
//   rounded once to bfloat16 as they are stored (common.cuh ld, st): half
//   the float32 build's bytes, the same operations.
// Excited states (EX = true, a compile-time flag; EX = false is the ground
// family's code as it was): after the top, the factor epilogue
// (separable.cuh ex_forward) multiplies psi by the radial nodes, the
// angular node and the transverse harmonic that the launch's factor code
// names, and forms lap psi by the product rule from the top's gradient
// coefficients. It runs on the scalar lanes (float64) or the point's
// thread, reading the per-point node heads c1, c2, n0; about a hundred
// operations a point, a few per cent of the kernel's time.
// Lanes past n evaluate the finite pad point and store nothing.

#include "separable.cuh"

using namespace sep;

namespace {

template <typename T, int H>
__host__ __device__ constexpr int smem_elems() {
  return 2 * Tile<H>::WSP + 2 * Tile<H>::ROWS * H + kFwdSlots * Tile<H>::P;
}

// The float64 build (S = T = double): one tile of P points a block. EX:
// the excited-state factor epilogue (separable.cuh ex_forward) after the
// top, reading the nodes c1, c2, n0 that the launch's factor code names.
template <typename S, int H, bool EX, typename T = kern::compute_t<S>>
__global__ void __launch_bounds__(kThreads, H > 16 ? 2 : 3)
    separable_fwd_kernel(const S* __restrict__ x, const S* __restrict__ y,
                         const S* __restrict__ z, const S* __restrict__ r,
                         const S* __restrict__ a, const S* __restrict__ b,
                         const S* __restrict__ c1, const S* __restrict__ c2,
                         const S* __restrict__ n0, const S* __restrict__ w,
                         S* __restrict__ psi, S* __restrict__ lap, int n,
                         T psym, T ry, T rz, int code) {
  using kern::ld;
  using TL = Tile<H>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sX = sw + 2 * TL::WSP;      // [3P][H] first-layer triples
  T* sY = sX + TL::ROWS * H;     // [3P][H] second-layer triples
  T* sV = sY + TL::ROWS * H;     // [slot][P] per-point vectors
  load_weights<T, H>(w, sw);
  __syncthreads();

  const int lp = threadIdx.x / TL::TPP;
  const bool lead = threadIdx.x % TL::TPP == 0;
  const bool scalar = threadIdx.x < TL::P;  // whole warps (Tile)
  const int tiles = (n + TL::P - 1) / TL::P;
  const T one = T(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the scalar lanes: geometry and GZ pair of point threadIdx.x
    const int p = tile * TL::P + threadIdx.x;
    const bool live = scalar && p < n;
    Point<T> pt;
    GZ<T> g;
    if (scalar) {
      point_gz(live ? ld(x[p]) : one, live ? ld(y[p]) : one,
               live ? ld(z[p]) : one, live ? ld(r[p]) : one, ry, rz,
               live ? ld(a[p]) : one, live ? ld(b[p]) : one, psym, pt, g);
      sV[kT0 * TL::P + threadIdx.x] = pt.t0;
      sV[kE0 * TL::P + threadIdx.x] = pt.e0;
      sV[kCf * TL::P + threadIdx.x] = pt.cf;
    }
    __syncthreads();
    // the MLPs, TPP lanes a point
    const T cf = sV[kCf * TL::P + lp];
    T o[6];
    mlp_tile_forward<T, H>(sw, sV[kT0 * TL::P + lp], cf, sX, sY, o[0], o[1],
                           o[2]);
    mlp_tile_forward<T, H>(sw + TL::WSP, sV[kE0 * TL::P + lp], cf, sX, sY,
                           o[3], o[4], o[5]);
    if (lead) {
#pragma unroll
      for (int c = 0; c < 6; ++c) sV[(kL0 + c) * TL::P + lp] = o[c];
    }
    __syncthreads();
    if (scalar) {
      const T* v = sV + threadIdx.x;
      Top<T> s;
      top_forward(v[kL0 * TL::P], v[kL1 * TL::P], v[kL2 * TL::P],
                  v[kM0 * TL::P], v[kM1 * TL::P], v[kM2 * TL::P], g, pt, s);
      if constexpr (EX) {
        const Factors fc = factors_of(code);
        T v1, v2, v0;
        load_nodes(fc, live, p, c1, c2, n0, v1, v2, v0);
        Ex<T> ex;
        ex_forward(fc, live ? ld(y[p]) : one, live ? ld(z[p]) : one,
                   live ? ld(r[p]) : one, ry, rz, v1, v2, v0,
                   v[kL1 * TL::P], v[kM1 * TL::P], g, pt, s, ex);
        if (live) {
          psi[p] = kern::st<S>(ex.psi);
          lap[p] = kern::st<S>(ex.lap);
        }
      } else {
        if (live) {
          psi[p] = kern::st<S>(s.psi);
          lap[p] = kern::st<S>(s.lap);
        }
      }
    }
  }
}

// S: the tensors' storage type (float or __nv_bfloat16); the arithmetic is
// float's. One thread a point and one block a tile (the wrapper's grid is
// n_tiles): with no loop over tiles the compiler keeps no weights in
// registers across one, and the kernel needs 116 registers at H = 16 where
// a grid-stride loop needed 128 and spilled.
template <typename S, int H, bool EX>
__global__ void __launch_bounds__(kPointThreads, H > 16 ? 2 : 4)
    separable_fwd_point_kernel(const S* __restrict__ x,
                               const S* __restrict__ y,
                               const S* __restrict__ z,
                               const S* __restrict__ r,
                               const S* __restrict__ a,
                               const S* __restrict__ b,
                               const S* __restrict__ c1,
                               const S* __restrict__ c2,
                               const S* __restrict__ n0,
                               const S* __restrict__ w, S* __restrict__ psi,
                               S* __restrict__ lap, int n, float psym,
                               float ry, float rz, int code) {
  using kern::ld;
  __shared__ __align__(16) float sw[2 * Tile<H>::WSP];
  load_weights<float, H, kPointThreads>(w, sw);
  __syncthreads();

  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  const bool live = p < n;
  Point<float> pt;
  GZ<float> g;
  point_gz(live ? ld(x[p]) : 1.0f, live ? ld(y[p]) : 1.0f,
           live ? ld(z[p]) : 1.0f, live ? ld(r[p]) : 1.0f, ry, rz,
           live ? ld(a[p]) : 1.0f, live ? ld(b[p]) : 1.0f, psym, pt, g);
  float l0, l1, l2, m0, m1, m2;
  mlp_point_forward<H, false>(sw, pt.t0, pt.cf, nullptr, nullptr, l0, l1,
                              l2);
  mlp_point_forward<H, false>(sw + Tile<H>::WSP, pt.e0, pt.cf, nullptr,
                              nullptr, m0, m1, m2);
  Top<float> s;
  top_forward(l0, l1, l2, m0, m1, m2, g, pt, s);
  if constexpr (EX) {
    const Factors fc = factors_of(code);
    float v1, v2, v0;
    load_nodes(fc, live, p, c1, c2, n0, v1, v2, v0);
    Ex<float> ex;
    ex_forward(fc, live ? ld(y[p]) : 1.0f, live ? ld(z[p]) : 1.0f,
               live ? ld(r[p]) : 1.0f, ry, rz, v1, v2, v0, l1, m1, g, pt, s,
               ex);
    if (live) {
      psi[p] = kern::st<S>(ex.psi);
      lap[p] = kern::st<S>(ex.lap);
    }
  } else {
    if (live) {
      psi[p] = kern::st<S>(s.psi);
      lap[p] = kern::st<S>(s.lap);
    }
  }
}

// Shared memory (bytes) of a launch beyond the static, set as the kernel's
// limit.
template <typename S, int H, bool EX>
cudaError_t prepare(size_t* smem) {
  if constexpr (tiled<S>()) {
    *smem = sizeof(S) * smem_elems<S, H>();
    return cudaFuncSetAttribute(separable_fwd_kernel<S, H, EX>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  } else {
    *smem = 0;
    return cudaSuccess;
  }
}

template <typename S, int H, bool EX>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* c1,
                   const void* c2, const void* n0, const void* w, void* psi,
                   void* lap, int n, int psym, int grid, int code, double ry,
                   double rz, cudaStream_t stream) {
  using T = kern::compute_t<S>;
  size_t smem;
  cudaError_t err = prepare<S, H, EX>(&smem);
  if (err != cudaSuccess) return err;
  const S* px = static_cast<const S*>(x);
  const S* py = static_cast<const S*>(y);
  const S* pz = static_cast<const S*>(z);
  const S* pr = static_cast<const S*>(r);
  const S* pa = static_cast<const S*>(a);
  const S* pb = static_cast<const S*>(b);
  const S* pc1 = static_cast<const S*>(c1);
  const S* pc2 = static_cast<const S*>(c2);
  const S* pn0 = static_cast<const S*>(n0);
  const S* pw = static_cast<const S*>(w);
  if constexpr (tiled<S>())
    separable_fwd_kernel<S, H, EX><<<grid, kThreads, smem, stream>>>(
        px, py, pz, pr, pa, pb, pc1, pc2, pn0, pw, static_cast<S*>(psi),
        static_cast<S*>(lap), n, T(psym), T(ry), T(rz), code);
  else
    separable_fwd_point_kernel<S, H, EX><<<grid, kPointThreads, 0, stream>>>(
        px, py, pz, pr, pa, pb, pc1, pc2, pn0, pw, static_cast<S*>(psi),
        static_cast<S*>(lap), n, T(psym), T(ry), T(rz), code);
  return cudaGetLastError();
}

// Resident blocks per SM and shared memory per block (bytes, static and
// dynamic) of the ground instantiation.
template <typename S, int H>
int occupancy(int* smem_bytes) {
  size_t smem;
  if (prepare<S, H, false>(&smem) != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err;
  if constexpr (tiled<S>()) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, separable_fwd_kernel<S, H, false>, kThreads, smem);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, separable_fwd_point_kernel<S, H, false>, kPointThreads,
        smem);
    smem = sizeof(float) * 2 * Tile<H>::WSP;
  }
  if (err != cudaSuccess) return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

// code: the factor code (0: the ground instantiations, EX = false).
template <typename S>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* c1, const void* c2,
             const void* n0, const void* w, void* psi, void* lap, int n,
             int hidden, int psym, int grid, int code, double ry, double rz,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code < 0 || ((code & 3) > 0 && !c1) || ((code & 3) > 1 && !c2) ||
      (((code >> 2) & 1) && !n0) || (code & 3) == 3)
    return static_cast<int>(cudaErrorInvalidValue);
#define SEP_FWD_CASE(HH)                                                      \
  case HH:                                                                    \
    return code ? launch<S, HH, true>(x, y, z, r, a, b, c1, c2, n0, w, psi,   \
                                      lap, n, psym, grid, code, ry, rz, s)    \
                : launch<S, HH, false>(x, y, z, r, a, b, c1, c2, n0, w, psi,  \
                                       lap, n, psym, grid, code, ry, rz, s);
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

// c1, c2, n0: the excited-state nodes a point (read where the factor code
// names their factor; null otherwise).
#define SEP_FWD_ENTRY(NAME, S)                                                 \
  extern "C" int NAME(const void* x, const void* y, const void* z,             \
                      const void* r, const void* a, const void* b,             \
                      const void* c1, const void* c2, const void* n0,          \
                      const void* w, void* psi, void* lap, int n, int hidden,  \
                      int psym, int grid, int code, double ry, double rz,      \
                      void* stream) {                                          \
    return dispatch<S>(x, y, z, r, a, b, c1, c2, n0, w, psi, lap, n, hidden,   \
                       psym, grid, code, ry, rz, stream);                      \
  }
SEP_FWD_ENTRY(separable_fwd_f64, double)
SEP_FWD_ENTRY(separable_fwd_f32, float)
SEP_FWD_ENTRY(separable_fwd_bf16, __nv_bfloat16)
#undef SEP_FWD_ENTRY

// Points a block takes at a time in the build of type code `type`
// (kern::TypeCode; bfloat16 as float32) at this width (the wrapper's
// n_tiles must agree), or -1.
extern "C" int separable_fwd_points_per_tile(int hidden, int type) {
#define SEP_FWD_TILE(HH)                                      \
  case HH:                                                    \
    return type == kern::kF64 ? points_per_tile<double, HH>() \
                              : points_per_tile<float, HH>();
  switch (hidden) {
    SEP_FWD_TILE(4)
    SEP_FWD_TILE(8)
    SEP_FWD_TILE(16)
    SEP_FWD_TILE(32)
    default:
      return -1;
  }
#undef SEP_FWD_TILE
}

extern "C" int separable_fwd_occupancy(int hidden, int type, int* smem_bytes) {
#define SEP_FWD_OCC(HH)                                                   \
  case HH:                                                                \
    return type == kern::kF64    ? occupancy<double, HH>(smem_bytes)      \
           : type == kern::kBF16 ? occupancy<__nv_bfloat16, HH>(smem_bytes) \
                                 : occupancy<float, HH>(smem_bytes);
  switch (hidden) {
    SEP_FWD_OCC(4)
    SEP_FWD_OCC(8)
    SEP_FWD_OCC(16)
    SEP_FWD_OCC(32)
    default:
      return -1;
  }
#undef SEP_FWD_OCC
}

extern "C" const char* separable_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
