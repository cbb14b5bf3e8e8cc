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
// Design, by type (chosen at compile time):
// - float32: one thread a point; nothing but the two outputs touches device
//   memory. The weights are loaded once per block into shared memory, where
//   every read is a broadcast (one load per 4 FMAs); each branch keeps its H
//   first-layer 4-stacks in registers (fully unrolled, H a template
//   parameter). The two branches run one after the other and the second
//   layer's units in a rolled loop: evaluated together, or unrolled, they
//   held too much in registers and spilled (668 B at H = 16). 160 registers,
//   3 blocks of 4 warps an SM, no spills; ~3x its operation bound, set by
//   the rate of FMA and shared-load instructions of the per-point products.
// - float64 (train_tile.cuh): one thread a point spilled (3.1 KB at H = 16)
//   and left the second layer to scalar FMAs at half the tensor-core rate. A
//   block of 256 threads takes a tile of 32 points (16 at H = 32): the
//   envelope geometry one thread a (branch, point) pair; the first layer
//   TPP threads a pair, H / TPP units each; the second layer's L = A W2 on
//   the float64 tensor cores, written over A; its sigmoid units and the
//   branch outputs per pair; psi and lap one thread a point. One block a
//   tile; 64 registers and 55 KB of shared memory at H = 16, 4 blocks of 8
//   warps an SM, no spills; ~6x its operation bound (the float64 sigmoids
//   and the 4 barriers a tile; not measured).
// Lanes past n evaluate the finite pad point and store nothing.

#include "train_tile.cuh"

using namespace trn;

namespace {

constexpr int kThreads = 128;  // the float32 kernel: one thread a point

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    train_fwd_point_kernel(const T* __restrict__ x, const T* __restrict__ y,
                           const T* __restrict__ z, const T* __restrict__ r,
                           const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ g, const T* __restrict__ w,
                           T* __restrict__ psi, T* __restrict__ lap, int n,
                           T psym, T ry, T rz) {
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

  // the GZ pair first, then one branch after the other: evaluated together
  // the two branches' stacks would not fit the registers
  Env<T> ep;
  branch_envelopes(xv, yv, zv, rv, ry, rz, av, false, ep);
  const GZ<T> q = gz(av, bv, ep);
  const T gzv = q.v1 + psym * q.v2;
  const T gzl = q.v1 * q.s1 + psym * (q.v2 * q.s2);
  T nnv = sw[L::OB], nnl = T(0);
#pragma unroll 1
  for (int m = 0; m < 2; ++m) {
    Env<T> e;
    branch_envelopes(xv, yv, zv, rv, ry, rz, av, m == 1, e);
    T a0[H], a1[H], a2[H], a3[H];
    layer1<T, H>(sw, e, a0, a1, a2, a3);
    // the second layer's units in a loop kept rolled: unrolled, the
    // compiler loads the weights of many units ahead and spills
    T v = T(0), l = T(0);
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const Unit2<T> u = unit2<T, H>(sw, k, e, a0, a1, a2, a3);
      v += u.bv * sw[L::OW + k];
      l += u.bl * sw[L::OW + k];
    }
    const T pb = m == 0 ? one : psym;
    nnv += pb * v;
    nnl += pb * l;
  }
  if (live) {
    const T gv = g[p];
    psi[p] = nnv * gv + gzv;
    lap[p] = nnl * gv + gzl;
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kTileThreads, 2)
    train_fwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ y,
                          const T* __restrict__ z, const T* __restrict__ r,
                          const T* __restrict__ a, const T* __restrict__ b,
                          const T* __restrict__ g, const T* __restrict__ w,
                          T* __restrict__ psi, T* __restrict__ lap, int n,
                          T psym, T ry, T rz) {
  using TL = Tile<H>;
  using L = Layout<H>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sW2 = sw + TL::WSP;           // [H][LD] W2
  T* sA = sW2 + H * TL::LD;        // [8P][LD] first-layer stacks, then L
  T* sV = sA + TL::ROWS * TL::LD;  // [slot][2P] per-pair vectors
  tile_load_weights<T, H>(w, sw, sW2);
  __syncthreads();

  const int bp = my_pair<H>(), q = my_lane<H>();
  const int tiles = (n + TL::P - 1) / TL::P;
  const T one = T(1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (threadIdx.x < TL::BP)
      tile_envelopes<T, H>(x, y, z, r, a, g, nullptr, nullptr, tile, n, psym,
                           ry, rz, sV);
    __syncthreads();
    const Env<T> e = tile_env<T, H>(sV, bp);
    tile_layer1<T, H>(sw, e, sA);
    __syncthreads();
    tile_product<T, H, false>(sA, sW2, sA);
    __syncthreads();
    // the second layer's units at the thread's pair, and the branch output
    T ov = T(0), ol = T(0);
#pragma unroll
    for (int i = 0; i < TL::UPT; ++i) {
      const int k = q + TL::TPP * i;
      const Unit2<T> u = unit2_act(
          sA[tile_row<H>(bp, 0) * TL::LD + k] + sw[L::B2 + k],
          sA[tile_row<H>(bp, 1) * TL::LD + k],
          sA[tile_row<H>(bp, 2) * TL::LD + k],
          sA[tile_row<H>(bp, 3) * TL::LD + k], e.c12);
      ov += u.bv * sw[L::OW + k];
      ol += u.bl * sw[L::OW + k];
    }
    ov = pair_sum<H>(ov);
    ol = pair_sum<H>(ol);
    if (q == 0) {
      sV[kOv * TL::BP + bp] = ov;
      sV[kOl * TL::BP + bp] = ol;
    }
    __syncthreads();
    // one thread a point: the gated network and the GZ pair
    if (threadIdx.x < TL::P) {
      const int t = threadIdx.x;
      const int p = tile * TL::P + t;
      const bool live = p < n;
      const Env<T> ep = tile_env<T, H>(sV, t);
      const T* bv = sV + kOv * TL::BP + t;  // both branches' outputs
      const T* bl = sV + kOl * TL::BP + t;
      const T nnv = sw[L::OB] + bv[0] + psym * bv[TL::P];
      const T nnl = bl[0] + psym * bl[TL::P];
      const GZ<T> gq = gz(live ? a[p] : one, live ? b[p] : one, ep);
      if (live) {
        const T gv = g[p];
        psi[p] = nnv * gv + gq.v1 + psym * gq.v2;
        lap[p] = nnl * gv + gq.v1 * gq.s1 + psym * (gq.v2 * gq.s2);
      }
    }
    __syncthreads();
  }
}

// Shared memory (bytes) of a launch, set as the kernel's limit.
template <typename T, int H>
cudaError_t prepare(size_t* smem) {
  if constexpr (std::is_same<T, double>::value) {
    *smem = sizeof(T) * tile_smem_elems<H>(1);
    return cudaFuncSetAttribute(train_fwd_tile_kernel<T, H>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  } else {
    *smem = 0;
    return cudaSuccess;
  }
}

template <typename T, int H>
constexpr int points_per_tile() {
  return std::is_same<T, double>::value ? Tile<H>::P : kThreads;
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* y, const void* z, const void* r,
                   const void* a, const void* b, const void* g, const void* w,
                   void* psi, void* lap, int n, int psym, double ry, double rz,
                   cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare<T, H>(&smem);
  if (err != cudaSuccess) return err;
  constexpr int per = points_per_tile<T, H>();
  const int blocks = n > 0 ? (n + per - 1) / per : 1;
  const T* px = static_cast<const T*>(x);
  const T* py = static_cast<const T*>(y);
  const T* pz = static_cast<const T*>(z);
  const T* pr = static_cast<const T*>(r);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* pg = static_cast<const T*>(g);
  const T* pw = static_cast<const T*>(w);
  if constexpr (std::is_same<T, double>::value)
    train_fwd_tile_kernel<T, H><<<blocks, kTileThreads, smem, stream>>>(
        px, py, pz, pr, pa, pb, pg, pw, static_cast<T*>(psi),
        static_cast<T*>(lap), n, T(psym), T(ry), T(rz));
  else
    train_fwd_point_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
        px, py, pz, pr, pa, pb, pg, pw, static_cast<T*>(psi),
        static_cast<T*>(lap), n, T(psym), T(ry), T(rz));
  return cudaGetLastError();
}

// Resident blocks per SM and shared memory per block (bytes).
template <typename T, int H>
int occupancy(int* smem_bytes) {
  size_t smem;
  if (prepare<T, H>(&smem) != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err;
  if constexpr (std::is_same<T, double>::value)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_fwd_tile_kernel<T, H>, kTileThreads, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_fwd_point_kernel<T, H>, kThreads, smem);
  if (err != cudaSuccess) return -1;
  *smem_bytes = static_cast<int>(smem);
  return blocks;
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

// Points a block takes at a time in the f64 (f64 != 0) or f32 kernel (the
// wrapper's n_tiles must agree), or -1.
extern "C" int train_fwd_points_per_tile(int hidden, int f64) {
#define TRAIN_FWD_TILE(HH) \
  case HH:                 \
    return f64 ? points_per_tile<double, HH>() : points_per_tile<float, HH>();
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

// Resident blocks per SM of the f64 (f64 != 0) or f32 instantiation at this
// width, and its shared memory per block in *smem_bytes; -1 on error.
extern "C" int train_fwd_occupancy(int hidden, int f64, int* smem_bytes) {
#define TRAIN_FWD_OCC(HH)                          \
  case HH:                                         \
    return f64 ? occupancy<double, HH>(smem_bytes) \
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

extern "C" const char* train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
