// The pieces the sweeps share: the column split of a sweep's grid
// (launch_split, segments_reduce_kernel) and the kind dispatch of the 1-D
// families (kind_switch).  Every sweep runs the value sweep's kernels
// (value_sweep.cuh): B1, B3, B8, B12 and B13 on its value entries, B2, B3
// and B9 on the gradient entries of tangent_sweep.cuh.
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

constexpr int REDUCE_THREADS = 256;  // the segment reduce's block

// out[r, j] = sum_g part[g, r, j] over g = 0 .. segs - 1, in that order;
// part (segs, rows, w), out (rows, ldo).
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
segments_reduce_kernel(const T* __restrict__ part, int segs, int rows,
                       int w, T* __restrict__ out, int ldo) {
  const long long e = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (e >= (long long)rows * w) return;
  const int r = (int)(e / w);
  const int j = (int)(e % w);
  T s = T(0);
  for (int g = 0; g < segs; ++g) s += part[((size_t)g * rows + r) * w + j];
  out[(size_t)r * ldo + j] = s;
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
  const int grid = (int)((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  segments_reduce_kernel<T><<<grid, REDUCE_THREADS, 0, stream>>>(
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
