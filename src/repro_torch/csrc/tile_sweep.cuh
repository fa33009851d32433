// The pieces the sweeps share: the column split of a sweep's grid
// (split_ok, launch_split, segments_reduce_kernel), the kind dispatch of
// the 1-D families (kind_switch), and for the N-D tangent sweep
// (tile_sweep_nd.cuh, B9) its shared-memory tile contraction
// (contract_tile, write_stripe).  B1, B3, B8, B12 and B13 run the value
// sweep (value_sweep.cuh), B2 and B3 on the gradient entries of
// tangent_sweep.cuh.
//
// The grid of every sweep is row stripes x column segments: each block
// owns a stripe of output rows and sweeps its segment of x2 in a loop.
// One segment per stripe (no two blocks write the same output) when the
// stripes alone fill the card; otherwise the column axis is cut into as
// many segments as bring the card to a few blocks per SM (the wrapper
// picks them, kernel_matvec.row_segments).  Then each block writes its
// partial stripe into a (segments, m n1, b) scratch and
// segments_reduce_kernel sums the segments in a fixed order.  No atomics:
// the result is the same from run to run.
#pragma once

#include <type_traits>

#include "tile_fns.cuh"

namespace tile {

// B9's grid and shared-memory tiles (SWEEP_THREADS also the segment
// reduce's block)
constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_ROWS = 32;
constexpr int SWEEP_COLS = 64;
constexpr int SWEEP_VCOLS = 64;
constexpr int SMEM_LIMIT = 232448;  // opt-in dynamic shared memory per block
constexpr int MAX_COLS = 512;       // V columns per launch

// Contract the m tiles in ks ((m, ROWS, COLS + 1) rows) with rows
// c0 .. c0 + COLS of V into acc (m, ROWS, b), one chunk of
// vw = min(b, VCOLS) columns of V at a time, staged in vs.  Called by the
// whole block after the tiles are written and synchronised.
template <typename T>
__device__ __forceinline__ void contract_tile(const T* ks, T* vs, T* acc,
                                              const T* __restrict__ v,
                                              int ldv, int b, int m, int c0,
                                              int n2) {
  const int tid = threadIdx.x;
  const int ks_stride = SWEEP_COLS + 1;
  const int vw = b < SWEEP_VCOLS ? b : SWEEP_VCOLS;
  const int vs_stride = vw + 1;
  for (int j0 = 0; j0 < b; j0 += vw) {
    const int w = (b - j0) < vw ? (b - j0) : vw;
    for (int e = tid; e < SWEEP_COLS * w; e += SWEEP_THREADS) {
      const int c = e / w;
      const int j = e % w;
      vs[c * vs_stride + j] =
          (c0 + c < n2) ? v[(size_t)(c0 + c) * ldv + j0 + j] : T(0);
    }
    __syncthreads();
    for (int e = tid; e < m * SWEEP_ROWS * w; e += SWEEP_THREADS) {
      const int j = e % w;
      const int ir = e / w;  // i * SWEEP_ROWS + r
      const T* krow = ks + ir * ks_stride;
      T s = T(0);
#pragma unroll 8
      for (int c = 0; c < SWEEP_COLS; ++c) s += krow[c] * vs[c * vs_stride + j];
      acc[ir * b + j0 + j] += s;
    }
    __syncthreads();
  }
}

// Write the stripe's accumulators acc (m, ROWS, b) to out[i, row0 + r, j]
// (out is (m, n1, ldo)), masking the rows past n1.
template <typename T>
__device__ __forceinline__ void write_stripe(const T* acc,
                                             T* __restrict__ out, int ldo,
                                             int b, int m, int row0,
                                             int n1) {
  const int n_acc = m * SWEEP_ROWS * b;
  for (int e = threadIdx.x; e < n_acc; e += SWEEP_THREADS) {
    const int j = e % b;
    const int ir = e / b;
    const int i = ir / SWEEP_ROWS;
    const int r = ir % SWEEP_ROWS;
    if (row0 + r < n1) out[((size_t)i * n1 + row0 + r) * ldo + j] = acc[e];
  }
}

// out[r, j] = sum_g part[g, r, j] over g = 0 .. segs - 1, in that order;
// part (segs, rows, w), out (rows, ldo).
template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS)
segments_reduce_kernel(const T* __restrict__ part, int segs, int rows,
                       int w, T* __restrict__ out, int ldo) {
  const long long e = (long long)blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (e >= (long long)rows * w) return;
  const int r = (int)(e / w);
  const int j = (int)(e % w);
  T s = T(0);
  for (int g = 0; g < segs; ++g) s += part[((size_t)g * rows + r) * w + j];
  out[(size_t)r * ldo + j] = s;
}

// The column split a sweep takes: segs segments of seg_cols columns (a
// multiple of SWEEP_COLS) that cover exactly n2 >= 1, at most 65,535 of
// them, and the scratch when there are two or more.
inline bool split_ok(int n2, int seg_cols, int segs, const void* part) {
  if (n2 <= 0 || segs < 1 || segs > 65535 || seg_cols <= 0 ||
      seg_cols % SWEEP_COLS)
    return false;
  if ((long long)(segs - 1) * seg_cols >= n2 ||
      (long long)segs * seg_cols < n2)
    return false;
  return segs == 1 || part != nullptr;
}

// Launch a sweep kernel on the (stripes, segs) grid, writing out directly
// (one segment) or the scratch part and then its ordered sum.  launch(dst,
// ldd, seg_stride) starts the sweep kernel.
template <typename T, typename Launch>
inline int launch_split(Launch launch, int m, int n1, int b, int segs,
                        T* part, T* out, int ldo, cudaStream_t stream) {
  if (segs == 1) {
    launch(out, ldo, (size_t)0);
    return (int)cudaGetLastError();
  }
  launch(part, b, (size_t)m * n1 * b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)m * n1 * b;
  const int grid = (int)((total + SWEEP_THREADS - 1) / SWEEP_THREADS);
  segments_reduce_kernel<T><<<grid, SWEEP_THREADS, 0, stream>>>(
      part, segs, m * n1, b, out, ldo);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, KIND>()) for the 1-D family id kind.
template <typename F>
static int kind_switch(int kind, F&& f) {
  switch (kind) {
    case K1: return f(std::integral_constant<int, K1>());
    case K2: return f(std::integral_constant<int, K2>());
    case SE: return f(std::integral_constant<int, SE>());
    case MATERN12: return f(std::integral_constant<int, MATERN12>());
    case MATERN32: return f(std::integral_constant<int, MATERN32>());
    case MATERN52: return f(std::integral_constant<int, MATERN52>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tile
