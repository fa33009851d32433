// B4: dense covariance block  out = K(x1, x2), (n1, n2) row-major, 1-D x.
//
// Replaces matrix_pallas / _tile_kernel (repro/kernels/kernel_tile.py).
//
// What bounds it on an H100: the block itself, written once (8 bytes an
// entry in float64: (8760, 512) is 35.9 MB, 10.7 us at 3.35 TB/s).  Inside
// k1's and k2's Wendland window an entry costs two sines and an exp, but
// at the main path's shapes most entries lie outside it, where the entry
// is exactly 0.  What the design does about it:
//
// - the entry of the value sweep (value_sweep.cuh, value_or_zero): the
//   parameters in registers and the reciprocals taken once per thread, so
//   no entry divides by l1, l2 or the lengthscale, and a finite |dt| >= T0
//   stored as 0 before any sin or exp (exact: fl(|dt| / T0) >= 1 there, so
//   the plain version's Wendland factor is 0 too).  A nan or inf dt takes
//   the full formula; an x beyond +-VALUE_BIG, whose dt the plain version's
//   sine overflows into a nan, gives 0 here, as in B1-B3;
// - each block writes a tile of MATRIX_ROWS = 8 rows x 128 columns, a
//   thread MATRIX_RPT = 2 rows of MATRIX_W = 4 columns 32 apart: x2 of a
//   thread's columns is loaded once into registers for all its rows, x1
//   once per row per warp (a broadcast), and each of a warp's stores
//   writes 32 consecutive entries of one row (256 bytes in float64), so
//   every store is coalesced whatever n2's alignment.  A window a few dozen
//   columns wide falls in one or two of a warp's four column groups, so
//   fewer warps diverge into the sin/exp path than with a thread's columns
//   side by side: on an H100 that layout (with 16-byte stores) took 0.024
//   ms at the main path's k2 block, this one 0.017 (PERF.md,
//   scripts/tile_matrix_variants.py).  Ragged edges are masked, nothing is
//   padded;
// - every block index lives on gridDim.x.
//
// Plain C interface for ctypes; returns the CUDA error code.
#include "value_sweep.cuh"

namespace tile {

constexpr int MATRIX_THREADS = 128;
constexpr int MATRIX_LANES = 32;  // threads along a row
constexpr int MATRIX_W = 4;       // columns per thread, 32 apart
constexpr int MATRIX_RPT = 2;     // rows per thread
constexpr int MATRIX_ROWS = MATRIX_THREADS / MATRIX_LANES * MATRIX_RPT;
constexpr int MATRIX_COLS = MATRIX_LANES * MATRIX_W;

template <typename T, int KIND>
__global__ void __launch_bounds__(MATRIX_THREADS)
tile_matrix_kernel(const T* __restrict__ params, const T* __restrict__ x1,
                   int n1, const T* __restrict__ x2, int n2, int col_tiles,
                   T* __restrict__ out) {
  T p[N_PARAM_SLOTS], q[N_PARAM_SLOTS];
#pragma unroll
  for (int s = 0; s < N_PARAM_SLOTS; ++s) p[s] = params[s];
  value_consts<T, KIND>(p, q);
  const int lane = threadIdx.x % MATRIX_LANES;
  const int warp = threadIdx.x / MATRIX_LANES;
  const int row0 = (int)(blockIdx.x / col_tiles) * MATRIX_ROWS;
  const int c0 = (int)(blockIdx.x % col_tiles) * MATRIX_COLS + lane;
  T xc[MATRIX_W];
#pragma unroll
  for (int w = 0; w < MATRIX_W; ++w)
    xc[w] = c0 + MATRIX_LANES * w < n2 ? x2[c0 + MATRIX_LANES * w] : T(0);
#pragma unroll
  for (int i = 0; i < MATRIX_RPT; ++i) {
    const int r = row0 + warp + (MATRIX_THREADS / MATRIX_LANES) * i;
    if (r >= n1) break;
    const T xr = x1[r];
    T* const o = out + (size_t)r * n2 + c0;
#pragma unroll
    for (int w = 0; w < MATRIX_W; ++w)
      if (c0 + MATRIX_LANES * w < n2)
        o[MATRIX_LANES * w] = value_or_zero<T, KIND>(xr - xc[w], p, q);
  }
}

template <typename T>
static int launch_matrix(int kind, const T* params, const T* x1, int n1,
                         const T* x2, int n2, T* out, cudaStream_t stream) {
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  const long long col_tiles = (n2 + MATRIX_COLS - 1) / MATRIX_COLS;
  const long long blocks =
      col_tiles * ((n1 + MATRIX_ROWS - 1) / MATRIX_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return kind_switch(kind, [&](auto k) {
    tile_matrix_kernel<T, decltype(k)::value>
        <<<(unsigned int)blocks, MATRIX_THREADS, 0, stream>>>(
            params, x1, n1, x2, n2, (int)col_tiles, out);
    return (int)cudaGetLastError();
  });
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
