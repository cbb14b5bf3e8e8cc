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
// 3.35 TB/s = 20 flop/byte). Two thirds of the operations are the second
// layers' products, 3 H^2 multiply-adds a point and MLP; the float64 tanh
// of the 4 H units is a software routine of tens of instructions each.
//
// Design (separable.cuh): a block of 256 threads takes one tile of P
// points (32 at H = 16). The first P threads compute the points' geometry
// and GZ pair, one a point, and later the bounded correction and product
// rule; in between, 8 threads a point evaluate the MLPs, whose tanh units
// they share, and each MLP's second layer runs as the tile product
// [3P, H] x [H, H] on the float64 tensor cores instead of 3 H^2 scalar
// multiply-adds a point. Shared memory holds the weights, two [3P, H] tiles
// and the per-point vectors (32 KB in float64 at H = 16), so several blocks
// are resident on an SM. Measured (chip_smoke.py phase 6) the kernel moved
// little against the one-thread-a-point design: removing the second layer's
// scalar multiply-adds, or the per-point work repeated on 8 lanes, did not
// set its time; the float64 tanh of the 4 H units and the tile's barriers
// remain. Lanes past n evaluate the finite pad point and store nothing.

#include "separable.cuh"

using namespace sep;

namespace {

template <typename T, int H>
__host__ __device__ constexpr int smem_elems() {
  return 2 * Tile<H>::WSP + 2 * Tile<H>::ROWS * H + kFwdSlots * Tile<H>::P;
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, H > 16 ? 2 : 3)
    separable_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ z, const T* __restrict__ r,
                         const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ w, T* __restrict__ psi,
                         T* __restrict__ lap, int n, T psym, T ry, T rz) {
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
      point_gz(live ? x[p] : one, live ? y[p] : one, live ? z[p] : one,
               live ? r[p] : one, ry, rz, live ? a[p] : one,
               live ? b[p] : one, psym, pt, g);
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
      if (live) {
        psi[p] = s.psi;
        lap[p] = s.lap;
      }
    }
  }
}

template <typename T, int H>
cudaError_t prepare(size_t* smem) {
  *smem = sizeof(T) * smem_elems<T, H>();
  return cudaFuncSetAttribute(separable_fwd_kernel<T, H>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* w, void* psi,
                   void* lap, int n, int psym, int grid, double ry, double rz,
                   cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare<T, H>(&smem);
  if (err != cudaSuccess) return err;
  separable_fwd_kernel<T, H><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(r),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(w), static_cast<T*>(psi), static_cast<T*>(lap), n,
      T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

// Resident blocks per SM and shared memory per block (bytes).
template <typename T, int H>
int occupancy(int* smem_bytes) {
  size_t smem;
  if (prepare<T, H>(&smem) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, separable_fwd_kernel<T, H>, kThreads, smem) != cudaSuccess)
    return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
}

template <typename T>
int dispatch(const void* x, const void* y, const void* z, const void* r,
             const void* a, const void* b, const void* w, void* psi, void* lap,
             int n, int hidden, int psym, int grid, double ry, double rz,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEP_FWD_CASE(HH)                                                   \
  case HH:                                                                 \
    return launch<T, HH>(x, y, z, r, a, b, w, psi, lap, n, psym, grid, ry, \
                         rz, s);
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
                                 int hidden, int psym, int grid, double ry,
                                 double rz, void* stream) {
  return dispatch<double>(x, y, z, r, a, b, w, psi, lap, n, hidden, psym, grid,
                          ry, rz, stream);
}

extern "C" int separable_fwd_f32(const void* x, const void* y, const void* z,
                                 const void* r, const void* a, const void* b,
                                 const void* w, void* psi, void* lap, int n,
                                 int hidden, int psym, int grid, double ry,
                                 double rz, void* stream) {
  return dispatch<float>(x, y, z, r, a, b, w, psi, lap, n, hidden, psym, grid,
                         ry, rz, stream);
}

// Points a tile at this width, the same in both types (the wrapper's
// grid_blocks must agree), or -1.
extern "C" int separable_fwd_points_per_tile(int hidden, int /*f64*/) {
  switch (hidden) {
    case 4: return Tile<4>::P;
    case 8: return Tile<8>::P;
    case 16: return Tile<16>::P;
    case 32: return Tile<32>::P;
    default: return -1;
  }
}

// Resident blocks per SM of the f64 (f64 != 0) or f32 instantiation at this
// width, and its shared memory per block in *smem_bytes; -1 on error.
extern "C" int separable_fwd_occupancy(int hidden, int f64, int* smem_bytes) {
#define SEP_FWD_OCC(HH)                                          \
  case HH:                                                       \
    return f64 ? occupancy<double, HH>(smem_bytes)               \
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
