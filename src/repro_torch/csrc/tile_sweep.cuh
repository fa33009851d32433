// Row-stripe sweep shared by the stacked tangent matvec (B2) and the
// one-direction tangent matvec (B3): out[i] = K_i(x1, x2) @ V for i < m,
// where K_i = sum_s pdots[i, s] dK/dp[s].  The direction bound DIRS is a
// template parameter: B2 takes MAX_DIRS (m <= 5 at run time), B3 takes 1,
// so its projection is one register dot per entry and its m a constant.
// The covariance matvec (B1) and the row slab (B12) have their own sweep,
// value_sweep.cuh; it shares split_ok's rule, launch_split and
// segments_reduce_kernel with this one, and the N-D sweeps
// (tile_sweep_nd.cuh) share contract_tile and write_stripe too.
//
// Replaces the Pallas kernels _matvec_stacked_tangent_kernel and
// _matvec_tangent_kernel of repro/kernels/kernel_matvec.py.  There the
// grid's sequential column axis revisits one output block.  Here the grid
// is row stripes x column segments: each block owns a stripe of SWEEP_ROWS
// output rows and sweeps its segment of x2 in a loop.  One segment per
// stripe (no two blocks write the same output) when the stripes alone fill
// the card; otherwise the column axis is cut into as many segments as
// bring the card to a few blocks per SM (the wrapper picks them,
// kernel_matvec.row_segments).  Then each block writes its partial stripe
// into a (segments, m n1, b) scratch and segments_reduce_kernel sums the
// segments in a fixed order.  No atomics: the result is the same from run
// to run.
//
// Per column tile the block evaluates the m SWEEP_ROWS x SWEEP_COLS
// tangent tiles ONCE into shared memory, then contracts them with V in
// chunks of SWEEP_VCOLS columns.  The (m, SWEEP_ROWS, b) accumulators also
// live in shared memory, so a wide V costs one gradient evaluation per
// entry, not one per chunk, and no accumulator sits in registers (nothing
// to spill at m = 5).
//
// What bounds it on an H100: nothing is read from device memory beyond x1,
// x2, V, the output and the scratch (O(n b) bytes), so the kernel is bound
// by operations: the fp64 sin/cos/exp of the gradient evaluation at small
// b, the fp64 FMAs of the contraction (two shared-memory loads each) at
// large b.  Ragged edges are masked in the kernel; nothing is padded.
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

template <typename T, int KIND, int DIRS>
__global__ void __launch_bounds__(SWEEP_THREADS)
tile_sweep_kernel(const T* __restrict__ params, const T* __restrict__ pdots,
                  int m_arg, const T* __restrict__ x1, int n1,
                  const T* __restrict__ x2, int n2, const T* __restrict__ v,
                  int ldv, int b, int seg_cols, T* __restrict__ out,
                  int ldo, size_t seg_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // one direction is a compile-time m (B3); otherwise m <= DIRS
  const int m = DIRS == 1 ? 1 : m_arg;
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
  const int c_begin = blockIdx.y * seg_cols;
  const int c_end = min(n2, c_begin + seg_cols);

  T p[N_PARAM_SLOTS];
#pragma unroll
  for (int s = 0; s < N_PARAM_SLOTS; ++s) p[s] = params[s];
  T pd[DIRS][MAX_SLOTS];
#pragma unroll
  for (int i = 0; i < DIRS; ++i)
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s)
      pd[i][s] = (i < m && s < NS) ? pdots[i * N_PARAM_SLOTS + s] : T(0);

  const int n_acc = m * SWEEP_ROWS * b;
  for (int e = tid; e < n_acc; e += SWEEP_THREADS) acc[e] = T(0);

  for (int c0 = c_begin; c0 < c_end; c0 += SWEEP_COLS) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < SWEEP_COLS) xs[tid] = (c0 + tid < c_end) ? x2[c0 + tid] : T(0);
    __syncthreads();

    // evaluate the m tangent tiles once
    for (int e = tid; e < SWEEP_ROWS * SWEEP_COLS; e += SWEEP_THREADS) {
      const int r = e / SWEEP_COLS;
      const int c = e % SWEEP_COLS;
      const bool ok = (row0 + r < n1) && (c0 + c < c_end);
      const T dt = ok ? x1[row0 + r] - xs[c] : T(0);
      T g[MAX_SLOTS];
#pragma unroll
      for (int s = 0; s < MAX_SLOTS; ++s) g[s] = T(0);
      if (ok) tile_grad<T, KIND>(dt, p, g);
#pragma unroll
      for (int i = 0; i < DIRS; ++i) {
        if (i < m) {
          T kt = T(0);
#pragma unroll
          for (int s = 0; s < NS; ++s) kt += pd[i][s] * g[s];
          ks[(i * SWEEP_ROWS + r) * ks_stride + c] = kt;
        }
      }
    }
    __syncthreads();

    contract_tile<T>(ks, vs, acc, v, ldv, b, m, c0, c_end);
  }
  write_stripe<T>(acc, out + blockIdx.y * seg_stride, ldo, b, m, row0, n1);
}

template <typename T, int KIND, int DIRS>
static int launch_sweep_kind(const T* params, const T* pdots, int m,
                             const T* x1, int n1, const T* x2, int n2,
                             const T* v, int ldv, int b, int seg_cols,
                             int segs, T* part, T* out, int ldo,
                             cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes(m, b, sizeof(T));
  auto fn = tile_sweep_kernel<T, KIND, DIRS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n1 + SWEEP_ROWS - 1) / SWEEP_ROWS, segs);
  return launch_split<T>(
      [&](T* dst, int ldd, size_t seg_stride) {
        fn<<<grid, SWEEP_THREADS, smem, stream>>>(
            params, pdots, m, x1, n1, x2, n2, v, ldv, b, seg_cols, dst, ldd,
            seg_stride);
      },
      m, n1, b, segs, part, out, ldo, stream);
}

#define SWEEP_ARGS params, pdots, m, x1, n1, x2, n2, v, ldv, b, seg_cols, \
    segs, part, out, ldo, stream

// DIRS: the most tangent directions the kernel takes (B2 MAX_DIRS, B3 1).
template <typename T, int DIRS = MAX_DIRS>
static int launch_sweep(int kind, const T* params, const T* pdots, int m,
                        const T* x1, int n1, const T* x2, int n2, const T* v,
                        int ldv, int b, int seg_cols, int segs, T* part,
                        T* out, int ldo, cudaStream_t stream) {
  if (n1 <= 0 || b <= 0 || m <= 0 || m > DIRS || b > MAX_COLS ||
      !split_ok(n2, seg_cols, segs, part) ||
      sweep_smem_bytes(m, b, sizeof(T)) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case K1: return launch_sweep_kind<T, K1, DIRS>(SWEEP_ARGS);
    case K2: return launch_sweep_kind<T, K2, DIRS>(SWEEP_ARGS);
    case SE: return launch_sweep_kind<T, SE, DIRS>(SWEEP_ARGS);
    case MATERN12:
      return launch_sweep_kind<T, MATERN12, DIRS>(SWEEP_ARGS);
    case MATERN32:
      return launch_sweep_kind<T, MATERN32, DIRS>(SWEEP_ARGS);
    case MATERN52:
      return launch_sweep_kind<T, MATERN52, DIRS>(SWEEP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

#undef SWEEP_ARGS

}  // namespace tile
