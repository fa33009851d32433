// The value sweep out = K(x1, x2) @ V for B1 (the covariance matvec) and
// B12 (the stochastic solver's row slab, x1 a pre-gathered batch of rows).
//
// Replaces matvec_pallas and matvec_rows_pallas
// (repro/kernels/kernel_matvec.py) and their body _matvec_kernel.  The
// grid is row stripes of VALUE_ROWS rows x column segments (whole tiles of
// VALUE_COLS columns), as the tile sweeps' (tile_sweep.cuh): one segment
// when the stripes fill the card, else a (segs, n1, b) scratch of partial
// stripes that segments_reduce_kernel sums in a fixed order.  No atomics
// anywhere, so every run gives the same bits.  K is never stored in device
// memory.
//
// What bounds it on an H100, and what the design does about it:
//
// - Narrow V (b <= VALUE_NARROW_MAX: every CG, SLQ and Lanczos launch,
//   b = 1, 8, 9) is bound by the fp64 evaluation of k (sin, exp and
//   divisions).  value_narrow_kernel evaluates and contracts in registers:
//   lane l of each warp owns rows l and l + 32 of the stripe, the block's
//   eight warps take turns over the segment's column tiles, and for each
//   column the x2 value and the V row are read from shared memory as a
//   broadcast, k(r, c) is formed in a register and multiply-added at once
//   into the B register accumulators of its row; it is never stored.  Each
//   warp stages its next tile (x2 and V) with cp.async while it evaluates
//   the current one.  The warps' partial stripes meet once, at the end,
//   through shared memory in warp order.  B (a template parameter, so the
//   accumulators are registers) is one of 1, 4, 8, 9 and 16; a launch
//   takes the smallest that holds its width and masks the tail.
// - Wide V (b > VALUE_NARROW_MAX: the predictive variance's b = 512 and
//   the slab's k = 256) is bound by the contraction, 2 b operations per
//   entry.  value_wide_kernel evaluates each 64 x 32 K tile once into
//   shared memory and contracts it on the fp64 tensor cores with
//   mma.sync.m8n8k4.f64 (wgmma has no f64); each warp keeps a 32-row x
//   VW / 4 slice of the output in registers over the whole segment, and
//   the V tiles are double-buffered with cp.async.  The grid's z axis
//   takes VW = 32 NB columns of V each (NB = 1, 2 or 4), so K is evaluated
//   once per VW columns.  float32 keeps full fp32 FMAs on the same
//   fragments (no TF32).
// - k1 and k2 vanish outside the Wendland window |dt| < T0.  A block
//   takes the [min, max] of its stripe's x1, and of each column tile's x2
//   by a warp reduction over the tile (kept_tiles), and skips a tile
//   whose interval gap is >= T0 whole: no evaluation, no staging, no
//   contraction.  Inside a kept tile an entry with |dt| >= T0 is 0 before
//   its sin and exp.  The skip is exact: fl(dt) >= fl(gap) >= T0 for every
//   pair, so fl(|dt| / T0) >= 1 and the plain version's entry is 0 too;
//   every skipped term is 0 * V, and the result differs from the unskipped
//   sum only where V holds an inf or a nan (0 * inf is a nan there).  A
//   stripe or tile with a value beyond +-VALUE_BIG (or a nan) skips
//   nothing.  On unsorted x few tiles are skipped and the result is the
//   same.  The SE and Matern kinds skip nothing (an exp that underflows is
//   no support).
//
// Operation order: the sine argument stays (pi * dt) / T (tile_fns.cuh);
// the divisions by l1 and l2 (k1, k2) and by the lengthscale (se, Matern)
// are products with a reciprocal taken once per block (value_entry).
// Ragged edges are masked in the kernels; nothing is padded.
#pragma once

#include "tile_fns.cuh"
#include "tile_sweep.cuh"

namespace tile {

constexpr int VALUE_THREADS = 256;
constexpr int VALUE_WARPS = VALUE_THREADS / 32;
constexpr int VALUE_RPT = 2;                    // rows per lane (narrow)
constexpr int VALUE_ROWS = 32 * VALUE_RPT;      // rows per stripe
constexpr int VALUE_COLS = 32;                  // columns per tile
constexpr int VALUE_NARROW_MAX = 16;            // widest V in registers
constexpr int VALUE_LIST = 256;                 // tiles per kept-tile list
constexpr int VALUE_MAX_COLS = 512;             // V columns per launch

template <int KIND>
__host__ __device__ constexpr bool has_support() {
  return KIND == K1 || KIND == K2;
}

// |x| <= VALUE_BIG keeps every difference of two such values finite.
__device__ __forceinline__ double value_big(double) { return 8.0e307; }
__device__ __forceinline__ float value_big(float) { return 1.7e38f; }

// ---------------------------------------------------------------------------
// cp.async (sm_80+): an element copy, zero-filled when !ok
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the entry k(dt)
// ---------------------------------------------------------------------------

// q: the per-block reciprocals value_entry multiplies by.
template <typename T, int KIND>
__device__ __forceinline__ void value_consts(const T* p, T* q) {
  if (KIND == K1 || KIND == K2) {
    q[2] = T(1) / p[2];
    q[4] = KIND == K2 ? T(1) / p[4] : T(0);
  } else {
    q[0] = T(1) / p[0];
  }
}

// tile_value with the divisions outside the sine argument as products.
template <typename T, int KIND>
__device__ __forceinline__ T value_entry(T dt, const T* p, const T* q) {
  const T pi = T(3.141592653589793);
  if (KIND == K1) {
    T s1 = sin(pi * dt / p[1]) * q[2];
    return wendland(dt / p[0]) * exp(T(-2) * s1 * s1);
  } else if (KIND == K2) {
    T s1 = sin(pi * dt / p[1]) * q[2];
    T s2 = sin(pi * dt / p[3]) * q[4];
    return wendland(dt / p[0]) * exp(T(-2) * (s1 * s1 + s2 * s2));
  } else if (KIND == SE) {
    T r = dt * q[0];
    return exp(T(-0.5) * r * r);
  } else if (KIND == MATERN12) {
    return exp(-fabs(dt) * q[0]);
  } else if (KIND == MATERN32) {
    T a = sqrt(T(3)) * fabs(dt) * q[0];
    return (T(1) + a) * exp(-a);
  } else {
    T a = sqrt(T(5)) * fabs(dt) * q[0];
    return (T(1) + a + a * a / T(3)) * exp(-a);
  }
}

// k(dt), 0 before any sin or exp where the Wendland factor is 0: a finite
// |dt| >= T0 gives fl(|dt| / T0) >= 1.  A nan or inf dt takes the full
// formula, which gives the plain version's nan.
template <typename T, int KIND>
__device__ __forceinline__ T value_or_zero(T dt, const T* p, const T* q) {
  if (has_support<KIND>()) {
    const T adt = fabs(dt);
    if (adt >= p[0] && isfinite(adt)) return T(0);
  }
  return value_entry<T, KIND>(dt, p, q);
}

// ---------------------------------------------------------------------------
// the support skip
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void warp_range(T& lo, T& hi, bool& fin) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  fin = __all_sync(0xffffffffu, fin);
}

// The [lo, hi] of the stripe's x1 over its valid rows, and whether all of
// them lie within +-VALUE_BIG; every warp computes the same.  xr[i] is row
// row0 + lane + 32 i (0 past n1).
template <typename T>
__device__ __forceinline__ void stripe_range(const T* __restrict__ x1,
                                             int n1, int row0,
                                             T (&xr)[VALUE_RPT], T& lo,
                                             T& hi, bool& fin) {
  const int lane = threadIdx.x & 31;
  lo = T(INFINITY);
  hi = T(-INFINITY);
  fin = true;
#pragma unroll
  for (int i = 0; i < VALUE_RPT; ++i) {
    const int r = row0 + lane + 32 * i;
    xr[i] = r < n1 ? x1[r] : T(0);
    if (r < n1) {
      lo = fmin(lo, xr[i]);
      hi = fmax(hi, xr[i]);
      fin = fin && fabs(xr[i]) <= value_big(xr[i]);
    }
  }
  warp_range(lo, hi, fin);
}

// Lists in order (list[0 .. count)) which of the nt column tiles from
// column cb on can hold a nonzero entry of the stripe [lo1, hi1] (fin1:
// the stripe is finite): a tile is dropped when both are finite and their
// gap is >= t0.  Block-wide; returns the count.
template <typename T>
__device__ int kept_tiles(int* list, int* flags, const T* __restrict__ x2,
                          int cb, int c_end, int nt, T lo1, T hi1, bool fin1,
                          T t0) {
  constexpr int U = 4;  // tiles whose loads a warp has in flight at once
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < nt; t += U * VALUE_WARPS) {
    T xv[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = cb + (t + u * VALUE_WARPS) * VALUE_COLS + lane;
      ok[u] = t + u * VALUE_WARPS < nt && c < c_end;
      xv[u] = ok[u] ? x2[c] : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u * VALUE_WARPS >= nt) break;  // uniform across the warp
      T lo = ok[u] ? xv[u] : T(INFINITY);
      T hi = ok[u] ? xv[u] : T(-INFINITY);
      bool fin = !ok[u] || fabs(xv[u]) <= value_big(xv[u]);
      warp_range(lo, hi, fin);
      if (lane == 0) {
        const bool drop = fin && fin1 && (lo1 - hi >= t0 || lo - hi1 >= t0);
        flags[t + u * VALUE_WARPS] = drop ? 0 : 1;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int g = 0; g < nt; g += 32) {
      const bool f = g + lane < nt && flags[g + lane] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[base + __popc(m & ((1u << lane) - 1u))] = g + lane;
      base += __popc(m);
    }
    if (lane == 0) flags[VALUE_LIST] = base;
  }
  __syncthreads();
  return flags[VALUE_LIST];
}

// Shared bytes of the kept-tile list: list[VALUE_LIST] | flags[VALUE_LIST]
// | count.
constexpr size_t VALUE_LIST_BYTES = sizeof(int) * (2 * VALUE_LIST + 1);

// ---------------------------------------------------------------------------
// narrow V: evaluate and contract in registers
// ---------------------------------------------------------------------------

// One warp's stage: the x2 tile (VALUE_COLS) | its V rows (VALUE_COLS, B).
template <typename T, int B>
__device__ __forceinline__ void stage_narrow(T* st,
                                             const T* __restrict__ x2,
                                             const T* __restrict__ v,
                                             int ldv, int w, int c0,
                                             int c_end) {
  const int lane = threadIdx.x & 31;
  cp_async(st + lane, x2 + (c0 + lane < c_end ? c0 + lane : 0),
           c0 + lane < c_end);
  T* vs = st + VALUE_COLS;
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int e = lane + 32 * u;  // vs[c * B + j]
    const int c = e / B;
    const int j = e % B;
    const bool ok = c0 + c < c_end && j < w;
    cp_async(vs + e, ok ? v + (size_t)(c0 + c) * ldv + j : v, ok);
  }
}

template <typename T, int B>
constexpr size_t narrow_smem_bytes() {
  return sizeof(T) * VALUE_WARPS * 2 * VALUE_COLS * (1 + B) +
         VALUE_LIST_BYTES;
}

// Two blocks per SM up to B = 9 (<= 128 registers; ptxas spills a few
// cold values of k1 and k2 at B = 8 and 9): at one block of eight warps
// the fp64 evaluation stalls on its own latency.  B = 16 keeps its
// registers (one block per SM, no spills).
template <typename T, int KIND, int B>
__global__ void __launch_bounds__(VALUE_THREADS, B <= 9 ? 2 : 1)
value_narrow_kernel(const T* __restrict__ params, const T* __restrict__ x1,
                    int n1, const T* __restrict__ x2, int n2,
                    const T* __restrict__ v, int ldv, int w, int seg_cols,
                    T* __restrict__ out, int ldo, size_t seg_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int STAGE = VALUE_COLS * (1 + B);
  T* const smem = reinterpret_cast<T*>(smem_raw);
  int* const list =
      reinterpret_cast<int*>(smem + VALUE_WARPS * 2 * STAGE);
  int* const flags = list + VALUE_LIST;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * VALUE_ROWS;
  const int c_begin = blockIdx.y * seg_cols;
  const int c_end = min(n2, c_begin + seg_cols);
  const int n_tiles = (c_end - c_begin + VALUE_COLS - 1) / VALUE_COLS;

  T p[N_PARAM_SLOTS], q[N_PARAM_SLOTS];
#pragma unroll
  for (int s = 0; s < N_PARAM_SLOTS; ++s) p[s] = params[s];
  value_consts<T, KIND>(p, q);

  T xr[VALUE_RPT], lo1, hi1;
  bool fin1;
  stripe_range(x1, n1, row0, xr, lo1, hi1, fin1);

  T acc[VALUE_RPT][B];
#pragma unroll
  for (int i = 0; i < VALUE_RPT; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) acc[i][j] = T(0);

  T* const st = smem + warp * 2 * STAGE;
  for (int t0 = 0; t0 < n_tiles; t0 += VALUE_LIST) {
    const int nt = min(VALUE_LIST, n_tiles - t0);
    const int cb = c_begin + t0 * VALUE_COLS;
    int n_kept = nt;
    if (has_support<KIND>())
      n_kept = kept_tiles(list, flags, x2, cb, c_end, nt, lo1, hi1, fin1,
                          p[0]);
    // the first column of the k-th kept tile
    auto col = [&](int k) {
      return cb + (has_support<KIND>() ? list[k] : k) * VALUE_COLS;
    };
    // warp w takes the kept tiles w, w + VALUE_WARPS, ...
    int k = warp;
    if (k < n_kept) stage_narrow<T, B>(st, x2, v, ldv, w, col(k), c_end);
    cp_async_commit();
    for (int s = 0; k < n_kept; k += VALUE_WARPS, s ^= 1) {
      const int kn = k + VALUE_WARPS;
      if (kn < n_kept)
        stage_narrow<T, B>(st + (s ^ 1) * STAGE, x2, v, ldv, w, col(kn),
                           c_end);
      cp_async_commit();  // possibly empty: wait<1> then covers tile k
      cp_async_wait<1>();
      __syncwarp();
      const T* xs = st + s * STAGE;
      const T* vs = xs + VALUE_COLS;
      const int c0 = col(k);
      const int nc = min(VALUE_COLS, c_end - c0);
#pragma unroll 2
      for (int c = 0; c < nc; ++c) {
        const T xc = xs[c];
#pragma unroll
        for (int i = 0; i < VALUE_RPT; ++i) {
          const T kv = value_or_zero<T, KIND>(xr[i] - xc, p, q);
#pragma unroll
          for (int j = 0; j < B; ++j) acc[i][j] += kv * vs[c * B + j];
        }
      }
      __syncwarp();
    }
    if (has_support<KIND>()) __syncthreads();  // list reused next chunk
  }

  // the warps' partial stripes, summed in warp order: red[(g B + j) ROWS
  // + r] reuses the stages
  cp_async_wait<0>();
  __syncthreads();
  T* const red = smem;
#pragma unroll
  for (int i = 0; i < VALUE_RPT; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
      red[(warp * B + j) * VALUE_ROWS + lane + 32 * i] = acc[i][j];
  __syncthreads();
  T* const dst = out + blockIdx.y * seg_stride;
  for (int e = threadIdx.x; e < VALUE_ROWS * w; e += VALUE_THREADS) {
    const int r = e % VALUE_ROWS;
    const int j = e / VALUE_ROWS;
    if (row0 + r >= n1) continue;
    T s = red[j * VALUE_ROWS + r];
#pragma unroll
    for (int g = 1; g < VALUE_WARPS; ++g)
      s += red[(g * B + j) * VALUE_ROWS + r];
    dst[(size_t)(row0 + r) * ldo + j] = s;
  }
}

// ---------------------------------------------------------------------------
// wide V: evaluate each tile once, contract on the fp64 tensor cores
// ---------------------------------------------------------------------------

// C (8 x 8) += A (8 x 4) B (4 x 8) on one warp's fragments (PTX
// mma.m8n8k4 .f64 layout, g = lane / 4, t = lane % 4): a = A[g][t],
// b = B[t][g], c[i] = C[g][2 t + i].
__device__ __forceinline__ void mma884(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// The same fragments in fp32 FMAs (no TF32): A[g][k] lives in lane
// 4 g + k and B[k][n] in lane 4 n + k.
__device__ __forceinline__ void mma884(float (&c)[2], float a, float b) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ak = __shfl_sync(0xffffffffu, a, 4 * g + k);
    const float b0 = __shfl_sync(0xffffffffu, b, 8 * t + k);
    const float b1 = __shfl_sync(0xffffffffu, b, 8 * t + 4 + k);
    c[0] = fmaf(ak, b0, c[0]);
    c[1] = fmaf(ak, b1, c[1]);
  }
}

// Shared layout of the wide kernel, in elements: x1 stripe (VALUE_ROWS) |
// K tile (VALUE_ROWS, KS) | 2 stages of x2 tile (VALUE_COLS) + V tile
// (VALUE_COLS, VS) | the kept-tile list.  KS and VS are padded so that
// the A and B fragment loads are free of bank conflicts.
template <int NB>
struct WideLayout {
  static constexpr int VW = 32 * NB;
  static constexpr int KS = VALUE_COLS + 4;
  static constexpr int VS = VW + 4;
  static constexpr int STAGE = VALUE_COLS + VALUE_COLS * VS;
  static constexpr int ELEMS = VALUE_ROWS + VALUE_ROWS * KS + 2 * STAGE;
};

template <typename T, int NB>
constexpr size_t wide_smem_bytes() {
  return sizeof(T) * WideLayout<NB>::ELEMS + VALUE_LIST_BYTES;
}

// The block's stage: x2 tile and V rows c0 .. c0 + VALUE_COLS, columns
// 0 .. wz of v (already offset to the block's first column).
template <typename T, int NB>
__device__ __forceinline__ void stage_wide(T* st, const T* __restrict__ x2,
                                           const T* __restrict__ v, int ldv,
                                           int wz, int c0, int c_end) {
  using L = WideLayout<NB>;
  const int tid = threadIdx.x;
  if (tid < VALUE_COLS)
    cp_async(st + tid, x2 + (c0 + tid < c_end ? c0 + tid : 0),
             c0 + tid < c_end);
  T* vs = st + VALUE_COLS;
#pragma unroll
  for (int u = 0; u < VALUE_COLS * L::VW / VALUE_THREADS; ++u) {
    const int e = tid + VALUE_THREADS * u;
    const int c = e / L::VW;
    const int j = e % L::VW;
    const bool ok = c0 + c < c_end && j < wz;
    cp_async(vs + c * L::VS + j, ok ? v + (size_t)(c0 + c) * ldv + j : v,
             ok);
  }
}

// Two blocks per SM (<= 128 registers), so that one block's evaluation
// overlaps the other's contraction.
template <typename T, int KIND, int NB>
__global__ void __launch_bounds__(VALUE_THREADS, 2)
value_wide_kernel(const T* __restrict__ params, const T* __restrict__ x1,
                  int n1, const T* __restrict__ x2, int n2,
                  const T* __restrict__ v, int ldv, int w, int seg_cols,
                  T* __restrict__ out, int ldo, size_t seg_stride) {
  using L = WideLayout<NB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const xs1 = reinterpret_cast<T*>(smem_raw);
  T* const ks = xs1 + VALUE_ROWS;
  T* const stages = ks + VALUE_ROWS * L::KS;
  int* const list = reinterpret_cast<int*>(stages + 2 * L::STAGE);
  int* const flags = list + VALUE_LIST;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * VALUE_ROWS;
  const int c_begin = blockIdx.y * seg_cols;
  const int c_end = min(n2, c_begin + seg_cols);
  const int n_tiles = (c_end - c_begin + VALUE_COLS - 1) / VALUE_COLS;
  const int j_base = blockIdx.z * L::VW;
  const int wz = min(L::VW, w - j_base);
  v += j_base;

  T p[N_PARAM_SLOTS], q[N_PARAM_SLOTS];
#pragma unroll
  for (int s = 0; s < N_PARAM_SLOTS; ++s) p[s] = params[s];
  value_consts<T, KIND>(p, q);

  T xr[VALUE_RPT], lo1, hi1;
  bool fin1;
  stripe_range(x1, n1, row0, xr, lo1, hi1, fin1);
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < VALUE_RPT; ++i) xs1[lane + 32 * i] = xr[i];
  }

  // warp (wr, wc) owns output rows 32 wr .. + 32 and columns
  // wc VW / 4 .. + VW / 4: 4 x NB fragments of 8 x 8
  const int wr = warp & 1;
  const int wc = warp >> 1;
  T acc[4][NB][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NB; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = T(0);

  for (int t0 = 0; t0 < n_tiles; t0 += VALUE_LIST) {
    const int nt = min(VALUE_LIST, n_tiles - t0);
    const int cb = c_begin + t0 * VALUE_COLS;
    int n_kept = nt;
    if (has_support<KIND>())
      n_kept = kept_tiles(list, flags, x2, cb, c_end, nt, lo1, hi1, fin1,
                          p[0]);
    auto col = [&](int k) {
      return cb + (has_support<KIND>() ? list[k] : k) * VALUE_COLS;
    };
    if (n_kept > 0) stage_wide<T, NB>(stages, x2, v, ldv, wz, col(0), c_end);
    cp_async_commit();
    for (int k = 0; k < n_kept; ++k) {
      if (k + 1 < n_kept)
        stage_wide<T, NB>(stages + ((k + 1) & 1) * L::STAGE, x2, v, ldv, wz,
                          col(k + 1), c_end);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile k staged by every thread; xs1 written
      const T* xs2 = stages + (k & 1) * L::STAGE;
      const T* vs = xs2 + VALUE_COLS;
      const int c0 = col(k);
      // evaluate the 64 x 32 tile: thread (warp, lane) rows warp + 8 u
#pragma unroll 2
      for (int u = 0; u < VALUE_ROWS / VALUE_WARPS; ++u) {
        const int r = warp + VALUE_WARPS * u;
        const bool ok = row0 + r < n1 && c0 + lane < c_end;
        ks[r * L::KS + lane] =
            ok ? value_or_zero<T, KIND>(xs1[r] - xs2[lane], p, q) : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < VALUE_COLS; k0 += 4) {
        T a[4], bf[NB];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          a[mi] = ks[(32 * wr + 8 * mi + g) * L::KS + k0 + t];
#pragma unroll
        for (int ni = 0; ni < NB; ++ni)
          bf[ni] = vs[(k0 + t) * L::VS + wc * 8 * NB + 8 * ni + g];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < NB; ++ni) mma884(acc[mi][ni], a[mi], bf[ni]);
      }
      __syncthreads();  // ks and this stage are rewritten next
    }
    if (has_support<KIND>()) __syncthreads();
  }
  cp_async_wait<0>();

  T* const dst = out + blockIdx.y * seg_stride + j_base;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r = row0 + 32 * wr + 8 * mi + g;
    if (r >= n1) continue;
#pragma unroll
    for (int ni = 0; ni < NB; ++ni)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = wc * 8 * NB + 8 * ni + 2 * t + i;
        if (j < wz) dst[(size_t)r * ldo + j] = acc[mi][ni][i];
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The column split: segs segments of seg_cols columns (whole tiles) that
// cover exactly n2 >= 1, at most 65,535, and the scratch when segs >= 2.
inline bool value_split_ok(int n2, int seg_cols, int segs, const void* part) {
  if (n2 <= 0 || segs < 1 || segs > 65535 || seg_cols <= 0 ||
      seg_cols % VALUE_COLS)
    return false;
  if ((long long)(segs - 1) * seg_cols >= n2 ||
      (long long)segs * seg_cols < n2)
    return false;
  return segs == 1 || part != nullptr;
}

template <typename T, typename Kernel>
static int launch_value(Kernel fn, size_t smem, dim3 grid, const T* params,
                        const T* x1, int n1, const T* x2, int n2, const T* v,
                        int ldv, int w, int seg_cols, int segs, T* part,
                        T* out, int ldo, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return launch_split<T>(
      [&](T* dst, int ldd, size_t seg_stride) {
        fn<<<grid, VALUE_THREADS, smem, stream>>>(params, x1, n1, x2, n2, v,
                                                  ldv, w, seg_cols, dst, ldd,
                                                  seg_stride);
      },
      1, n1, w, segs, part, out, ldo, stream);
}

#define VALUE_ARGS params, x1, n1, x2, n2, v, ldv, w, seg_cols, segs, part, \
    out, ldo, stream

template <typename T, int KIND, int B>
static int launch_narrow(const T* params, const T* x1, int n1, const T* x2,
                         int n2, const T* v, int ldv, int w, int seg_cols,
                         int segs, T* part, T* out, int ldo,
                         cudaStream_t stream) {
  const dim3 grid((n1 + VALUE_ROWS - 1) / VALUE_ROWS, segs);
  return launch_value<T>(value_narrow_kernel<T, KIND, B>,
                         narrow_smem_bytes<T, B>(), grid, VALUE_ARGS);
}

template <typename T, int KIND, int NB>
static int launch_wide(const T* params, const T* x1, int n1, const T* x2,
                       int n2, const T* v, int ldv, int w, int seg_cols,
                       int segs, T* part, T* out, int ldo,
                       cudaStream_t stream) {
  const dim3 grid((n1 + VALUE_ROWS - 1) / VALUE_ROWS, segs,
                  (w + 32 * NB - 1) / (32 * NB));
  return launch_value<T>(value_wide_kernel<T, KIND, NB>,
                         wide_smem_bytes<T, NB>(), grid, VALUE_ARGS);
}

// Narrow widths 1 (value-only CG), 4, 8 (Lanczos), 9 (the training CG's
// 1 + 8 probes) and 16; wide ones in 32, 64 or 128 columns per block.
// Each width is one more kernel per kind and type for nvcc to build.
template <typename T, int KIND>
static int launch_value_kind(const T* params, const T* x1, int n1,
                             const T* x2, int n2, const T* v, int ldv, int w,
                             int seg_cols, int segs, T* part, T* out, int ldo,
                             cudaStream_t stream) {
  if (w <= 1) return launch_narrow<T, KIND, 1>(VALUE_ARGS);
  if (w <= 4) return launch_narrow<T, KIND, 4>(VALUE_ARGS);
  if (w <= 8) return launch_narrow<T, KIND, 8>(VALUE_ARGS);
  if (w <= 9) return launch_narrow<T, KIND, 9>(VALUE_ARGS);
  if (w <= VALUE_NARROW_MAX) return launch_narrow<T, KIND, 16>(VALUE_ARGS);
  if (w <= 32) return launch_wide<T, KIND, 1>(VALUE_ARGS);
  if (w <= 64) return launch_wide<T, KIND, 2>(VALUE_ARGS);
  return launch_wide<T, KIND, 4>(VALUE_ARGS);
}

// out (n1, ldo) = K(x1, x2) @ v[:, :w] (v (n2, ldv)); part: the (segs, n1,
// w) scratch, unused (may be null) when segs == 1.
template <typename T>
static int launch_value_sweep(int kind, const T* params, const T* x1, int n1,
                              const T* x2, int n2, const T* v, int ldv, int w,
                              int seg_cols, int segs, T* part, T* out,
                              int ldo, cudaStream_t stream) {
  if (n1 <= 0 || w <= 0 || w > VALUE_MAX_COLS ||
      !value_split_ok(n2, seg_cols, segs, part))
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case K1: return launch_value_kind<T, K1>(VALUE_ARGS);
    case K2: return launch_value_kind<T, K2>(VALUE_ARGS);
    case SE: return launch_value_kind<T, SE>(VALUE_ARGS);
    case MATERN12: return launch_value_kind<T, MATERN12>(VALUE_ARGS);
    case MATERN32: return launch_value_kind<T, MATERN32>(VALUE_ARGS);
    case MATERN52: return launch_value_kind<T, MATERN52>(VALUE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

#undef VALUE_ARGS

}  // namespace tile
