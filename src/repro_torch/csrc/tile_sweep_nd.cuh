// Row-stripe sweep of the stacked tangents of a separable product kernel
// on (n, d) coordinates, B9 (tile_tangent_nd.cu): out[i] = K_i(x1, x2) @ V
// for i < m, K_i = sum_a (sum_s pdots[i, a, s] dk_a/dp[s]) prod_{b != a}
// k_b: the product rule applied by hand.  (The product's value, B8 and
// B13, runs the value sweep of value_sweep.cuh.)
//
// Replaces the Pallas kernel _matvec_stacked_tangent_kernel_nd of
// repro/kernels/kernel_matvec.py, which linearises the product tile with
// jax.linearize; CUDA has no such thing, so each entry evaluates every
// factor's value and closed-form gradient once (tile_grad in tile_fns.cuh)
// and each direction is the product rule over those.
//
// Layout: x1 (n1, d) and x2 (n2, d) row-major, params (d, 8), pdots
// (m, d, 8).  The grid is tile_sweep.cuh's (stripes of SWEEP_ROWS output
// rows x column segments, each block's segment of x2 in a loop, the
// segments' partial stripes summed in a fixed order; no atomics); the m
// tangent tiles are evaluated once into shared memory and contracted with
// V in chunks (contract_tile), and:
//   * the family of each axis is dispatched at run time inside the tile
//     evaluation (a switch on a uniform value, no divergence), so one
//     kernel takes every tuple of families: templating on the tuple would
//     be 6^d instantiations and minutes of nvcc at d = 3;
//   * the parameter and direction blocks sit in shared memory, not in
//     registers ((d, 8) and (m, d, 8) values).
// It takes d <= MAX_AXES factors and m <= MAX_DIRS_ND directions; the C
// entry points refuse more.  Ragged edges are masked; nothing is padded.
//
// What bounds it on an H100: nothing is read from device memory beyond x1, x2, V and the output (O(n (d + b)) bytes), so
// it is bound by operations: d factor values and gradients (fp64 exp, and
// sin/cos for k1/k2) per entry at small b, the fp64 FMAs of the
// contraction at large b.  The design shares one evaluation of all d
// factor gradients across the b columns and m directions.
#pragma once

#include "tile_fns.cuh"
#include "tile_sweep.cuh"

namespace tile {

constexpr int MAX_DIRS_ND = 10;

template <typename T>
__device__ __forceinline__ T tile_grad_rt(int kind, T dt, const T* p, T* g) {
  switch (kind) {
    case K1: return tile_grad<T, K1>(dt, p, g);
    case K2: return tile_grad<T, K2>(dt, p, g);
    case SE: return tile_grad<T, SE>(dt, p, g);
    case MATERN12: return tile_grad<T, MATERN12>(dt, p, g);
    case MATERN32: return tile_grad<T, MATERN32>(dt, p, g);
    default: return tile_grad<T, MATERN52>(dt, p, g);
  }
}

// Shared layout in elements: params (d, 8) | pdots (m, d, 8) | x2 tile
// (COLS, d) | K tiles (m, ROWS, COLS + 1) | V chunk (COLS, vw + 1) |
// accumulators (m, ROWS, b), vw = min(b, VCOLS).
inline size_t sweep_nd_smem_bytes(int m, int d, int b, size_t elem) {
  int vw = b < SWEEP_VCOLS ? b : SWEEP_VCOLS;
  size_t n = (size_t)d * N_PARAM_SLOTS + (size_t)m * d * N_PARAM_SLOTS +
             (size_t)SWEEP_COLS * d +
             (size_t)m * SWEEP_ROWS * (SWEEP_COLS + 1) +
             (size_t)SWEEP_COLS * (vw + 1) + (size_t)m * SWEEP_ROWS * b;
  return n * elem;
}

inline int sweep_nd_max_cols(int m, int d, size_t elem) {
  int b = MAX_COLS;
  while (b > 1 && sweep_nd_smem_bytes(m, d, b, elem) > (size_t)SMEM_LIMIT)
    --b;
  return b;
}

template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS)
tile_sweep_nd_kernel(int d, int code, const T* __restrict__ params,
                     const T* __restrict__ pdots, int m,
                     const T* __restrict__ x1, int n1,
                     const T* __restrict__ x2, int n2,
                     const T* __restrict__ v, int ldv, int b,
                     int seg_cols, T* __restrict__ out, int ldo,
                     size_t seg_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks_stride = SWEEP_COLS + 1;
  const int vw = b < SWEEP_VCOLS ? b : SWEEP_VCOLS;
  const int vs_stride = vw + 1;
  T* ps = reinterpret_cast<T*>(smem_raw);
  T* pds = ps + d * N_PARAM_SLOTS;
  T* xs = pds + m * d * N_PARAM_SLOTS;
  T* ks = xs + SWEEP_COLS * d;
  T* vs = ks + m * SWEEP_ROWS * ks_stride;
  T* acc = vs + SWEEP_COLS * vs_stride;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * SWEEP_ROWS;
  const int c_begin = blockIdx.y * seg_cols;
  const int c_end = min(n2, c_begin + seg_cols);

  for (int e = tid; e < d * N_PARAM_SLOTS; e += SWEEP_THREADS)
    ps[e] = params[e];
  for (int e = tid; e < m * d * N_PARAM_SLOTS; e += SWEEP_THREADS)
    pds[e] = pdots[e];
  const int n_acc = m * SWEEP_ROWS * b;
  for (int e = tid; e < n_acc; e += SWEEP_THREADS) acc[e] = T(0);

  for (int c0 = c_begin; c0 < c_end; c0 += SWEEP_COLS) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < SWEEP_COLS * d; e += SWEEP_THREADS)
      xs[e] = (c0 + e / d < c_end) ? x2[(size_t)c0 * d + e] : T(0);
    __syncthreads();

    // evaluate the m tangent tiles of the product once
    for (int e = tid; e < SWEEP_ROWS * SWEEP_COLS; e += SWEEP_THREADS) {
      const int r = e / SWEEP_COLS;
      const int c = e % SWEEP_COLS;
      const bool ok = (row0 + r < n1) && (c0 + c < c_end);
      const T* xr = x1 + (size_t)(ok ? row0 + r : 0) * d;
      const T* xc = xs + c * d;
      T kv[MAX_AXES];
      T gv[MAX_AXES][MAX_SLOTS];
#pragma unroll
      for (int a = 0; a < MAX_AXES; ++a) {
        kv[a] = T(0);
#pragma unroll
        for (int s = 0; s < MAX_SLOTS; ++s) gv[a][s] = T(0);
        if (ok && a < d)
          kv[a] = tile_grad_rt<T>(axis_kind(code, a), xr[a] - xc[a],
                                  ps + a * N_PARAM_SLOTS, gv[a]);
      }
      for (int i = 0; i < m; ++i) {
        T kt = T(0);
#pragma unroll
        for (int a = 0; a < MAX_AXES; ++a) {
          if (a < d) {
            const T* pd = pds + (i * d + a) * N_PARAM_SLOTS;
            T dk = T(0);
#pragma unroll
            for (int s = 0; s < MAX_SLOTS; ++s) dk += pd[s] * gv[a][s];
#pragma unroll
            for (int bb = 0; bb < MAX_AXES; ++bb)
              if (bb < d && bb != a) dk *= kv[bb];
            kt += dk;
          }
        }
        ks[(i * SWEEP_ROWS + r) * ks_stride + c] = kt;
      }
    }
    __syncthreads();

    contract_tile<T>(ks, vs, acc, v, ldv, b, m, c0, c_end);
  }
  write_stripe<T>(acc, out + blockIdx.y * seg_stride, ldo, b, m, row0, n1);
}

template <typename T>
static int launch_sweep_nd(int d, int code, const T* params, const T* pdots,
                           int m, const T* x1, int n1, const T* x2, int n2,
                           const T* v, int ldv, int b, int seg_cols, int segs,
                           T* part, T* out, int ldo, cudaStream_t stream) {
  if (d < 1 || d > MAX_AXES || n1 <= 0 || b <= 0 || m <= 0 ||
      m > MAX_DIRS_ND || b > MAX_COLS || !split_ok(n2, seg_cols, segs, part))
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < d; ++a)
    if (axis_kind(code, a) > MATERN52) return (int)cudaErrorInvalidValue;
  const size_t smem = sweep_nd_smem_bytes(m, d, b, sizeof(T));
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto fn = tile_sweep_nd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n1 + SWEEP_ROWS - 1) / SWEEP_ROWS, segs);
  return launch_split<T>(
      [&](T* dst, int ldd, size_t seg_stride) {
        fn<<<grid, SWEEP_THREADS, smem, stream>>>(
            d, code, params, pdots, m, x1, n1, x2, n2, v, ldv, b, seg_cols,
            dst, ldd, seg_stride);
      },
      m, n1, b, segs, part, out, ldo, stream);
}

}  // namespace tile
