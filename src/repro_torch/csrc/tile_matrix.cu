// B4: dense covariance block  out = K(x1, x2), (n1, n2) row-major.
//
// Replaces matrix_pallas / _tile_kernel (repro/kernels/kernel_tile.py).  One
// entry per thread; consecutive threads take consecutive columns, so the
// writes along n2 coalesce.  Bound by bytes on an H100 for the cheap kinds
// (8 bytes written per entry) and by the fp64 sin/exp for k1/k2.  Ragged
// edges are masked, nothing is padded.  Plain C interface for ctypes.
#include "tile_fns.cuh"

namespace tile {

constexpr int MATRIX_THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

template <typename T, int KIND>
__global__ void __launch_bounds__(MATRIX_THREADS)
tile_matrix_kernel(const T* __restrict__ params, const T* __restrict__ x1,
                   int n1, const T* __restrict__ x2, int n2,
                   T* __restrict__ out) {
  T p[N_PARAM_SLOTS];
#pragma unroll
  for (int s = 0; s < N_PARAM_SLOTS; ++s) p[s] = params[s];
  const int c = blockIdx.x * MATRIX_THREADS + threadIdx.x;
  if (c >= n2) return;
  const T xc = x2[c];
  for (int r = blockIdx.y; r < n1; r += gridDim.y)
    out[(size_t)r * n2 + c] = tile_value<T, KIND>(x1[r] - xc, p);
}

template <typename T, int KIND>
static int launch_matrix_kind(const T* params, const T* x1, int n1,
                              const T* x2, int n2, T* out,
                              cudaStream_t stream) {
  dim3 grid((n2 + MATRIX_THREADS - 1) / MATRIX_THREADS,
            n1 < MAX_GRID_Y ? n1 : MAX_GRID_Y);
  tile_matrix_kernel<T, KIND><<<grid, MATRIX_THREADS, 0, stream>>>(
      params, x1, n1, x2, n2, out);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_matrix(int kind, const T* params, const T* x1, int n1,
                         const T* x2, int n2, T* out, cudaStream_t stream) {
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case K1: return launch_matrix_kind<T, K1>(params, x1, n1, x2, n2, out, stream);
    case K2: return launch_matrix_kind<T, K2>(params, x1, n1, x2, n2, out, stream);
    case SE: return launch_matrix_kind<T, SE>(params, x1, n1, x2, n2, out, stream);
    case MATERN12: return launch_matrix_kind<T, MATERN12>(params, x1, n1, x2, n2, out, stream);
    case MATERN32: return launch_matrix_kind<T, MATERN32>(params, x1, n1, x2, n2, out, stream);
    case MATERN52: return launch_matrix_kind<T, MATERN52>(params, x1, n1, x2, n2, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tile

extern "C" int tile_matrix_f64(int kind, const void* params, const void* x1,
                               int n1, const void* x2, int n2, void* out,
                               void* stream) {
  return tile::launch_matrix<double>(kind, (const double*)params,
                                     (const double*)x1, n1,
                                     (const double*)x2, n2, (double*)out,
                                     (cudaStream_t)stream);
}

extern "C" int tile_matrix_f32(int kind, const void* params, const void* x1,
                               int n1, const void* x2, int n2, void* out,
                               void* stream) {
  return tile::launch_matrix<float>(kind, (const float*)params,
                                    (const float*)x1, n1, (const float*)x2,
                                    n2, (float*)out, (cudaStream_t)stream);
}
