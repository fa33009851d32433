// Row-stripe sweep shared by the covariance matvec (B1) and the stacked
// tangent matvec (B2): out[i] = K_i(x1, x2) @ V for i < m, where K_0 = K
// (value mode) or K_i = sum_s pdots[i, s] dK/dp[s] (tangent mode).
//
// Replaces the Pallas kernels _matvec_kernel and
// _matvec_stacked_tangent_kernel of repro/kernels/kernel_matvec.py.  There
// the grid's sequential column axis revisits one output block; here each
// block owns a stripe of SWEEP_ROWS output rows and sweeps all of x2 in a
// loop, so no two blocks write the same output and the sum order is fixed
// (no atomics: the result is the same from run to run).
//
// Per column tile the block evaluates the SWEEP_ROWS x SWEEP_COLS tile of
// k (or of the m tangents) ONCE into shared memory, then contracts it with
// V in chunks of SWEEP_VCOLS columns.  The (m, SWEEP_ROWS, b) accumulators
// also live in shared memory, so a wide V (b = 512 in the predictive
// variance) costs one sin/exp evaluation per entry, not one per chunk, and
// no accumulator sits in registers (nothing to spill at m = 5).
//
// What bounds it on an H100: nothing is read from device memory beyond x1,
// x2, V and the output (O(n b) bytes), so the kernel is bound by operations:
// the fp64 sin/exp of the tile evaluation at small b, the fp64 FMAs of the
// contraction (two shared-memory loads each) at large b.  Ragged edges are
// masked in the kernel; nothing is padded.
#pragma once

#include "tile_fns.cuh"

namespace tile {

constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_ROWS = 32;
constexpr int SWEEP_COLS = 64;
constexpr int SWEEP_VCOLS = 64;
constexpr int SMEM_LIMIT = 232448;  // opt-in dynamic shared memory per block
constexpr int MAX_COLS = 512;       // V columns per launch

// Shared layout in elements: x2 tile | K tiles (m, ROWS, COLS + 1) |
// V chunk (COLS, vw + 1) | accumulators (m, ROWS, b), vw = min(b, VCOLS).
inline size_t sweep_smem_bytes(int m, int b, size_t elem) {
  int vw = b < SWEEP_VCOLS ? b : SWEEP_VCOLS;
  size_t n = SWEEP_COLS + (size_t)m * SWEEP_ROWS * (SWEEP_COLS + 1) +
             (size_t)SWEEP_COLS * (vw + 1) + (size_t)m * SWEEP_ROWS * b;
  return n * elem;
}

// Widest V (columns) that one launch takes for m directions.
inline int sweep_max_cols(int m, size_t elem) {
  int b = MAX_COLS;
  while (b > 1 && sweep_smem_bytes(m, b, elem) > (size_t)SMEM_LIMIT) --b;
  return b;
}

template <typename T, int KIND, bool TANGENT>
__global__ void __launch_bounds__(SWEEP_THREADS)
tile_sweep_kernel(const T* __restrict__ params, const T* __restrict__ pdots,
                  int m, const T* __restrict__ x1, int n1,
                  const T* __restrict__ x2, int n2, const T* __restrict__ v,
                  int ldv, int b, T* __restrict__ out, int ldo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NS = kind_slots<KIND>();
  const int ks_stride = SWEEP_COLS + 1;
  const int vw = b < SWEEP_VCOLS ? b : SWEEP_VCOLS;
  const int vs_stride = vw + 1;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ks = xs + SWEEP_COLS;
  T* vs = ks + m * SWEEP_ROWS * ks_stride;
  T* acc = vs + SWEEP_COLS * vs_stride;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * SWEEP_ROWS;

  T p[N_PARAM_SLOTS];
#pragma unroll
  for (int s = 0; s < N_PARAM_SLOTS; ++s) p[s] = params[s];
  T pd[MAX_DIRS][MAX_SLOTS];
  if (TANGENT) {
#pragma unroll
    for (int i = 0; i < MAX_DIRS; ++i)
#pragma unroll
      for (int s = 0; s < MAX_SLOTS; ++s)
        pd[i][s] = (i < m && s < NS) ? pdots[i * N_PARAM_SLOTS + s] : T(0);
  }

  const int n_acc = m * SWEEP_ROWS * b;
  for (int e = tid; e < n_acc; e += SWEEP_THREADS) acc[e] = T(0);

  for (int c0 = 0; c0 < n2; c0 += SWEEP_COLS) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < SWEEP_COLS) xs[tid] = (c0 + tid < n2) ? x2[c0 + tid] : T(0);
    __syncthreads();

    // evaluate the tile (or its m tangents) once
    for (int e = tid; e < SWEEP_ROWS * SWEEP_COLS; e += SWEEP_THREADS) {
      const int r = e / SWEEP_COLS;
      const int c = e % SWEEP_COLS;
      const bool ok = (row0 + r < n1) && (c0 + c < n2);
      const T dt = ok ? x1[row0 + r] - xs[c] : T(0);
      if (!TANGENT) {
        ks[r * ks_stride + c] = ok ? tile_value<T, KIND>(dt, p) : T(0);
      } else {
        T g[MAX_SLOTS];
#pragma unroll
        for (int s = 0; s < MAX_SLOTS; ++s) g[s] = T(0);
        if (ok) tile_grad<T, KIND>(dt, p, g);
#pragma unroll
        for (int i = 0; i < MAX_DIRS; ++i) {
          if (i < m) {
            T kt = T(0);
#pragma unroll
            for (int s = 0; s < NS; ++s) kt += pd[i][s] * g[s];
            ks[(i * SWEEP_ROWS + r) * ks_stride + c] = kt;
          }
        }
      }
    }
    __syncthreads();

    // contract with V, one chunk of vw columns at a time
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

  for (int e = tid; e < n_acc; e += SWEEP_THREADS) {
    const int j = e % b;
    const int ir = e / b;
    const int i = ir / SWEEP_ROWS;
    const int r = ir % SWEEP_ROWS;
    if (row0 + r < n1) out[((size_t)i * n1 + row0 + r) * ldo + j] = acc[e];
  }
}

template <typename T, int KIND, bool TANGENT>
static int launch_sweep_kind(const T* params, const T* pdots, int m,
                             const T* x1, int n1, const T* x2, int n2,
                             const T* v, int ldv, int b, T* out, int ldo,
                             cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes(m, b, sizeof(T));
  auto fn = tile_sweep_kernel<T, KIND, TANGENT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n1 + SWEEP_ROWS - 1) / SWEEP_ROWS;
  fn<<<grid, SWEEP_THREADS, smem, stream>>>(params, pdots, m, x1, n1, x2, n2,
                                            v, ldv, b, out, ldo);
  return (int)cudaGetLastError();
}

template <typename T, bool TANGENT>
static int launch_sweep(int kind, const T* params, const T* pdots, int m,
                        const T* x1, int n1, const T* x2, int n2, const T* v,
                        int ldv, int b, T* out, int ldo, cudaStream_t stream) {
  if (n1 <= 0 || b <= 0 || m <= 0 || m > MAX_DIRS || b > MAX_COLS ||
      sweep_smem_bytes(m, b, sizeof(T)) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case K1: return launch_sweep_kind<T, K1, TANGENT>(params, pdots, m, x1, n1, x2, n2, v, ldv, b, out, ldo, stream);
    case K2: return launch_sweep_kind<T, K2, TANGENT>(params, pdots, m, x1, n1, x2, n2, v, ldv, b, out, ldo, stream);
    case SE: return launch_sweep_kind<T, SE, TANGENT>(params, pdots, m, x1, n1, x2, n2, v, ldv, b, out, ldo, stream);
    case MATERN12: return launch_sweep_kind<T, MATERN12, TANGENT>(params, pdots, m, x1, n1, x2, n2, v, ldv, b, out, ldo, stream);
    case MATERN32: return launch_sweep_kind<T, MATERN32, TANGENT>(params, pdots, m, x1, n1, x2, n2, v, ldv, b, out, ldo, stream);
    case MATERN52: return launch_sweep_kind<T, MATERN52, TANGENT>(params, pdots, m, x1, n1, x2, n2, v, ldv, b, out, ldo, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tile
