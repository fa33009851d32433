// The value sweep out = K(x1, x2) @ V for B1 (the covariance matvec), B12
// (the stochastic solver's row slab, x1 a pre-gathered batch of rows), and
// on (n, d) coordinates for the separable product kinds, B8 (the product
// matvec) and B13 (its row slab): K = prod_a k_a(x1[a] - x2[a]).
//
// Replaces matvec_pallas, matvec_rows_pallas, matvec_pallas_nd and
// matvec_rows_pallas_nd (repro/kernels/kernel_matvec.py) and their bodies
// _matvec_kernel and _matvec_kernel_nd.  The grid is row stripes of
// VALUE_ROWS rows x column segments (whole tiles of VALUE_COLS columns), as
// the tile sweeps' (tile_sweep.cuh): one segment when the stripes fill the
// card, else a (segs, n1, b) scratch of partial stripes that
// segments_reduce_kernel sums in a fixed order.  No atomics anywhere, so
// every run gives the same bits.  K is never stored in device memory.
//
// What bounds it on an H100, and what the design does about it:
//
// - Narrow V (b <= VALUE_NARROW_MAX: every CG, SLQ and Lanczos launch,
//   b = 1, 8, 9) is bound by the fp64 evaluation of k (sin, exp and
//   divisions).  value_narrow_kernel evaluates and contracts in registers:
//   lane l of each warp owns rows l and l + 32 of the stripe (row l alone
//   of a 32-row stripe where an entry's NS values times B would hold more
//   than 16 accumulators per row: B2's gradient slots), the block's
//   eight warps take turns over the segment's column tiles, and for each
//   column the x2 value(s) and the V row are read from shared memory as a
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
//   no support), and neither do the products (no tile skip; a k1 or k2
//   factor is 0 before its sin and exp outside its window).
//
// The entry: the kernels take an entry type.  Each gives NS values per
// (x1, x2) pair, and the narrow kernel keeps NS x B accumulators per row
// and, for an entry that asks for it (PROJECT), projects the NS slot sums
// on the m directions of pdots once per output row as it writes them.
// The covariance has NS = 1: one family is ValueEntry<T, KIND>, x1 and x2
// one coordinate each.  The tangent sweeps B2, B3 and B9 run the same
// kernels on the gradient entries of tangent_sweep.cuh.  The products are
// two more "kinds",
// VALUE_PRODUCT2 for d <= 2 (the (n, 2) points of the main path) and
// VALUE_PRODUCT4 for d <= MAX_AXES (ProductEntry): each point carries 2 or
// MAX_AXES coordinate registers (d of them used), each axis's family
// is a run-time switch on a warp-uniform value (templating on the tuple of
// families would be 6^d instantiations), and each axis's constants sit in
// five registers (axis_consts), loaded and inverted once per block.  The
// stages keep axis a of a tile's x2 at [a VALUE_COLS + c] (and of the wide
// kernel's stripe at [a VALUE_ROWS + r]).
//
// Operation order: the sine argument stays (pi * dt) / T (tile_fns.cuh);
// the divisions by l1 and l2 (k1, k2) and by the lengthscale (se, Matern)
// are products with a reciprocal taken once per block (value_entry); a
// product multiplies its factors in axis order.  Ragged edges are masked in
// the kernels; nothing is padded.
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
// the product "kinds": d <= 2 factors (the main path's (n, 2) points) and
// d <= MAX_AXES, each point's coordinates and constants in registers
constexpr int VALUE_PRODUCT2 = 6;
constexpr int VALUE_PRODUCT4 = 7;
constexpr int AXIS_CONSTS = 5;                  // constants per product axis

template <int KIND>
__host__ __device__ constexpr bool has_support() {
  return KIND == K1 || KIND == K2;
}

// Rows per lane of the narrow kernel for an entry of ns values at width b:
// two while a row's ns b accumulators stay <= 16 (every NS = 1 entry),
// else one, so that B2's and B9's gradient slots (k2: 5 b) stay in
// registers.
__host__ __device__ constexpr int narrow_rpt(int ns, int b) {
  return ns * b <= 16 ? 2 : 1;
}

// Blocks per SM the narrow kernel asks for: two (<= 128 registers) while a
// lane holds <= 18 accumulators over two rows, or <= 45 in one row (B2's
// gradient slots up to k2 at b = 9: spilling cold values of the evaluation
// costs less than half the SM's warps, PERF.md), else one (no cap below
// 255).
__host__ __device__ constexpr int narrow_blocks(int ns, int b) {
  return narrow_rpt(ns, b) == 2 ? (2 * ns * b <= 18 ? 2 : 1)
                                : (ns * b <= 45 ? 2 : 1);
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

// k(dt) with the divisions outside the sine argument as products.
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

// One product axis's constants, laid out so that value_entry and
// value_or_zero read them as both p and q: k1/k2 (T0, T1, 1/l1, T2, 1/l2),
// the others (1/ell).
template <typename T>
__device__ __forceinline__ void axis_consts(int kind, const T* p,
                                            T (&c)[AXIS_CONSTS]) {
#pragma unroll
  for (int s = 0; s < AXIS_CONSTS; ++s) c[s] = T(0);
  if (kind == K1 || kind == K2) {
    c[0] = p[0];
    c[1] = p[1];
    c[2] = T(1) / p[2];
    if (kind == K2) {
      c[3] = p[3];
      c[4] = T(1) / p[4];
    }
  } else {
    c[0] = T(1) / p[0];
  }
}

// One product factor k_a(dt), its family a warp-uniform run-time value.
template <typename T>
__device__ __forceinline__ T axis_value(int kind, T dt,
                                        const T (&c)[AXIS_CONSTS]) {
  switch (kind) {
    case K1: return value_or_zero<T, K1>(dt, c, c);
    case K2: return value_or_zero<T, K2>(dt, c, c);
    case SE: return value_entry<T, SE>(dt, c, c);
    case MATERN12: return value_entry<T, MATERN12>(dt, c, c);
    case MATERN32: return value_entry<T, MATERN32>(dt, c, c);
    default: return value_entry<T, MATERN52>(dt, c, c);
  }
}

// An entry type gives D (coordinates per point), NS (values per pair),
// PROJECT (the narrow kernel writes out[i] = sum_s coef(pdots, i, s) S[s]
// for i < m, S the NS slot sums; else out = S, NS = 1), SUPPORT (a
// Wendland window of half-width t0() that the kernels may skip outside),
// load(params, pdots, d, code), called once per block, and e(x1, x2, g),
// which writes the pair's NS values to g.

// The entry k(x1, x2) of one family, its constants in registers.
template <typename T, int KIND>
struct ValueEntry {
  static constexpr int D = 1;
  static constexpr int NS = 1;
  static constexpr bool PROJECT = false;
  static constexpr bool SUPPORT = has_support<KIND>();
  T p[N_PARAM_SLOTS], q[N_PARAM_SLOTS];
  __device__ __forceinline__ void load(const T* __restrict__ params,
                                       const T*, int, int) {
#pragma unroll
    for (int s = 0; s < N_PARAM_SLOTS; ++s) p[s] = params[s];
    value_consts<T, KIND>(p, q);
  }
  __device__ __forceinline__ T t0() const { return p[0]; }
  __device__ __forceinline__ void operator()(const T (&x1)[1],
                                             const T (&x2)[1],
                                             T (&g)[1]) const {
    g[0] = value_or_zero<T, KIND>(x1[0] - x2[0], p, q);
  }
};

// The product entry prod_{a < d} k_a(x1[a] - x2[a]), d <= DIMS; params
// (d, 8).
template <typename T, int DIMS>
struct ProductEntry {
  static constexpr int D = DIMS;
  static constexpr int NS = 1;
  static constexpr bool PROJECT = false;
  static constexpr bool SUPPORT = false;
  T c[D][AXIS_CONSTS];
  int d, code;
  __device__ __forceinline__ void load(const T* __restrict__ params,
                                       const T*, int d_, int code_) {
    d = d_;
    code = code_;
#pragma unroll
    for (int a = 0; a < D; ++a)
      axis_consts<T>(a < d ? axis_kind(code, a) : SE,
                     params + (a < d ? a : 0) * N_PARAM_SLOTS, c[a]);
  }
  __device__ __forceinline__ T t0() const { return T(0); }
  __device__ __forceinline__ void operator()(const T (&x1)[D],
                                             const T (&x2)[D],
                                             T (&g)[1]) const {
    T k = T(1);
#pragma unroll
    for (int a = 0; a < D; ++a)
      if (a < d) k *= axis_value<T>(axis_kind(code, a), x1[a] - x2[a], c[a]);
    g[0] = k;
  }
};

template <typename T>
struct ValueEntry<T, VALUE_PRODUCT2> : ProductEntry<T, 2> {};
template <typename T>
struct ValueEntry<T, VALUE_PRODUCT4> : ProductEntry<T, MAX_AXES> {};

// The lane's rows of the stripe: xr[i][a] = coordinate a of row row0 +
// lane + 32 i (x1 row stride dd; 0 past n1 and past d).
template <typename T, int D, int RPT>
__device__ __forceinline__ void load_stripe(const T* __restrict__ x1,
                                            int n1, int row0, int dd, int d,
                                            T (&xr)[RPT][D]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + lane + 32 * i;
#pragma unroll
    for (int a = 0; a < D; ++a)
      xr[i][a] = (r < n1 && (D == 1 || a < d)) ? x1[(size_t)r * dd + a]
                                               : T(0);
  }
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

// The [lo, hi] of the stripe's x1 over its valid rows (xr from
// load_stripe), and whether all of them lie within +-VALUE_BIG; every warp
// computes the same.
template <typename T, int RPT>
__device__ __forceinline__ void stripe_range(int n1, int row0,
                                             const T (&xr)[RPT][1],
                                             T& lo, T& hi, bool& fin) {
  const int lane = threadIdx.x & 31;
  lo = T(INFINITY);
  hi = T(-INFINITY);
  fin = true;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (row0 + lane + 32 * i < n1) {
      lo = fmin(lo, xr[i][0]);
      hi = fmax(hi, xr[i][0]);
      fin = fin && fabs(xr[i][0]) <= value_big(xr[i][0]);
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

// One warp's stage: the x2 tile (D, VALUE_COLS) | its V rows (VALUE_COLS,
// B).  x2 has row stride dd and d coordinates per point.
template <typename T, int D, int B>
__device__ __forceinline__ void stage_narrow(T* st,
                                             const T* __restrict__ x2,
                                             int dd, int d,
                                             const T* __restrict__ v,
                                             int ldv, int w, int c0,
                                             int c_end) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const bool ok = c0 + lane < c_end && (D == 1 || a < d);
    cp_async(st + a * VALUE_COLS + lane,
             ok ? x2 + (size_t)(c0 + lane) * dd + a : x2, ok);
  }
  T* vs = st + D * VALUE_COLS;
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int e = lane + 32 * u;  // vs[c * B + j]
    const int c = e / B;
    const int j = e % B;
    const bool ok = c0 + c < c_end && j < w;
    cp_async(vs + e, ok ? v + (size_t)(c0 + c) * ldv + j : v, ok);
  }
}

// Shared elements of the narrow kernel before the kept-tile list: the
// warps' stages, reused at the end for the warps' partial stripes
// (VALUE_WARPS, B, rows) and, for a projecting entry, the stripe's slot
// sums (NS, B, rows).
template <typename Entry, int B>
__host__ __device__ constexpr int narrow_elems() {
  constexpr int rows = 32 * narrow_rpt(Entry::NS, B);
  constexpr int stages = VALUE_WARPS * 2 * VALUE_COLS * (Entry::D + B);
  constexpr int red =
      (VALUE_WARPS + (Entry::PROJECT ? Entry::NS : 0)) * B * rows;
  return stages > red ? stages : red;
}

template <typename T, typename Entry, int B>
constexpr size_t narrow_smem_bytes() {
  return sizeof(T) * narrow_elems<Entry, B>() + VALUE_LIST_BYTES;
}

// Two blocks per SM up to narrow_blocks' accumulator counts (B <= 9 for
// the value entries; <= 128 registers, ptxas spills a few cold values of
// k1 and k2 at B = 8 and 9): at one block of eight warps the fp64
// evaluation stalls on its own latency.  Wider ones keep their registers
// (one block per SM).  Lane l owns rows l + 32 i, i < RPT, of a
// stripe of 32 RPT rows (narrow_rpt).  A projecting entry's NS slot sums
// are projected on its m directions as they are written:
// out[i, r, j] = sum_s coef(pdots, i, s) S[s, r, j], out (m, n1, ldo).
template <typename T, typename Entry, int B>
__global__ void __launch_bounds__(VALUE_THREADS,
                                  narrow_blocks(Entry::NS, B))
value_narrow_kernel(int d, int code, const T* __restrict__ params,
                    const T* __restrict__ pdots, int m,
                    const T* __restrict__ x1, int n1,
                    const T* __restrict__ x2, int n2,
                    const T* __restrict__ v, int ldv, int w, int seg_cols,
                    T* __restrict__ out, int ldo, size_t seg_stride) {
  constexpr int D = Entry::D;
  constexpr int NS = Entry::NS;
  constexpr bool SUPPORT = Entry::SUPPORT;
  constexpr int RPT = narrow_rpt(NS, B);
  constexpr int ROWS = 32 * RPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int STAGE = VALUE_COLS * (D + B);
  T* const smem = reinterpret_cast<T*>(smem_raw);
  int* const list = reinterpret_cast<int*>(smem + narrow_elems<Entry, B>());
  int* const flags = list + VALUE_LIST;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int c_begin = blockIdx.y * seg_cols;
  const int c_end = min(n2, c_begin + seg_cols);
  const int n_tiles = (c_end - c_begin + VALUE_COLS - 1) / VALUE_COLS;
  const int dd = D == 1 ? 1 : d;  // the coordinates' row stride

  Entry ent;
  ent.load(params, pdots, d, code);

  T xr[RPT][D];
  load_stripe<T, D, RPT>(x1, n1, row0, dd, d, xr);
  T lo1 = T(0), hi1 = T(0);
  bool fin1 = false;
  if constexpr (SUPPORT) stripe_range<T, RPT>(n1, row0, xr, lo1, hi1, fin1);

  T acc[RPT][NS][B];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < B; ++j) acc[i][s][j] = T(0);

  T* const st = smem + warp * 2 * STAGE;
  for (int t0 = 0; t0 < n_tiles; t0 += VALUE_LIST) {
    const int nt = min(VALUE_LIST, n_tiles - t0);
    const int cb = c_begin + t0 * VALUE_COLS;
    int n_kept = nt;
    if constexpr (SUPPORT)
      n_kept = kept_tiles(list, flags, x2, cb, c_end, nt, lo1, hi1, fin1,
                          ent.t0());
    // the first column of the k-th kept tile
    auto col = [&](int k) {
      return cb + (SUPPORT ? list[k] : k) * VALUE_COLS;
    };
    // warp w takes the kept tiles w, w + VALUE_WARPS, ...
    int k = warp;
    if (k < n_kept)
      stage_narrow<T, D, B>(st, x2, dd, d, v, ldv, w, col(k), c_end);
    cp_async_commit();
    for (int s = 0; k < n_kept; k += VALUE_WARPS, s ^= 1) {
      const int kn = k + VALUE_WARPS;
      if (kn < n_kept)
        stage_narrow<T, D, B>(st + (s ^ 1) * STAGE, x2, dd, d, v, ldv, w,
                              col(kn), c_end);
      cp_async_commit();  // possibly empty: wait<1> then covers tile k
      cp_async_wait<1>();
      __syncwarp();
      const T* xs = st + s * STAGE;
      const T* vs = xs + D * VALUE_COLS;
      const int c0 = col(k);
      const int nc = min(VALUE_COLS, c_end - c0);
#pragma unroll 2
      for (int c = 0; c < nc; ++c) {
        T xc[D];
#pragma unroll
        for (int a = 0; a < D; ++a) xc[a] = xs[a * VALUE_COLS + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          T g[NS];
          ent(xr[i], xc, g);
#pragma unroll
          for (int j = 0; j < B; ++j) {
            const T vj = vs[c * B + j];
#pragma unroll
            for (int q = 0; q < NS; ++q) acc[i][q][j] += g[q] * vj;
          }
        }
      }
      __syncwarp();
    }
    if constexpr (SUPPORT) __syncthreads();  // list reused next chunk
  }

  // the warps' partial stripes, summed in warp order one slot at a time:
  // red[(g B + j) ROWS + r] reuses the stages; a projecting entry's sums
  // go to sum[(s B + j) ROWS + r] and are projected on pdots below
  cp_async_wait<0>();
  __syncthreads();
  T* const red = smem;
  T* const sum = smem + VALUE_WARPS * B * ROWS;
  T* const dst = out + blockIdx.y * seg_stride;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s > 0) __syncthreads();  // the last slot's sums are read
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j)
        red[(warp * B + j) * ROWS + lane + 32 * i] = acc[i][s][j];
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * w; e += VALUE_THREADS) {
      const int r = e % ROWS;
      const int j = e / ROWS;
      if (row0 + r >= n1) continue;
      T t = red[j * ROWS + r];
#pragma unroll
      for (int g = 1; g < VALUE_WARPS; ++g)
        t += red[(g * B + j) * ROWS + r];
      if constexpr (Entry::PROJECT)
        sum[(s * B + j) * ROWS + r] = t;
      else
        dst[(size_t)(row0 + r) * ldo + j] = t;
    }
  }
  if constexpr (Entry::PROJECT) {
    __syncthreads();
    for (int e = threadIdx.x; e < m * ROWS * w; e += VALUE_THREADS) {
      const int r = e % ROWS;
      const int j = (e / ROWS) % w;
      const int i = e / (ROWS * w);
      if (row0 + r >= n1) continue;
      T o = T(0);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        o += ent.coef(pdots, i, s) * sum[(s * B + j) * ROWS + r];
      dst[((size_t)i * n1 + row0 + r) * ldo + j] = o;
    }
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

// Shared layout of the wide kernel, in elements: x1 stripe (D,
// VALUE_ROWS) | K tile (VALUE_ROWS, KS) | 2 stages of x2 tile (D,
// VALUE_COLS) + V tile (VALUE_COLS, VS) | the kept-tile list.  KS and VS
// are padded so that the A and B fragment loads are free of bank
// conflicts.
template <int NB, int D>
struct WideLayout {
  static constexpr int VW = 32 * NB;
  static constexpr int KS = VALUE_COLS + 4;
  static constexpr int VS = VW + 4;
  static constexpr int XS = D * VALUE_COLS;
  static constexpr int STAGE = XS + VALUE_COLS * VS;
  static constexpr int ELEMS = D * VALUE_ROWS + VALUE_ROWS * KS + 2 * STAGE;
};

template <typename T, typename Entry, int NB>
constexpr size_t wide_smem_bytes() {
  return sizeof(T) * WideLayout<NB, Entry::D>::ELEMS +
         VALUE_LIST_BYTES;
}

// The block's stage: x2 tile and V rows c0 .. c0 + VALUE_COLS, columns
// 0 .. wz of v (already offset to the block's first column).
template <typename T, int NB, int D>
__device__ __forceinline__ void stage_wide(T* st, const T* __restrict__ x2,
                                           int dd, int d,
                                           const T* __restrict__ v, int ldv,
                                           int wz, int c0, int c_end) {
  using L = WideLayout<NB, D>;
  const int tid = threadIdx.x;
  if (tid < L::XS) {
    const int a = tid / VALUE_COLS;
    const int c = tid % VALUE_COLS;
    const bool ok = c0 + c < c_end && (D == 1 || a < d);
    cp_async(st + tid, ok ? x2 + (size_t)(c0 + c) * dd + a : x2, ok);
  }
  T* vs = st + L::XS;
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
// overlaps the other's contraction.  The entry gives one value (NS = 1).
template <typename T, typename Entry, int NB>
__global__ void __launch_bounds__(VALUE_THREADS, 2)
value_wide_kernel(int d, int code, const T* __restrict__ params,
                  const T* __restrict__ pdots, int,
                  const T* __restrict__ x1, int n1,
                  const T* __restrict__ x2, int n2,
                  const T* __restrict__ v, int ldv, int w, int seg_cols,
                  T* __restrict__ out, int ldo, size_t seg_stride) {
  static_assert(Entry::NS == 1, "the wide kernel contracts one K tile");
  constexpr int D = Entry::D;
  constexpr bool SUPPORT = Entry::SUPPORT;
  using L = WideLayout<NB, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const xs1 = reinterpret_cast<T*>(smem_raw);
  T* const ks = xs1 + D * VALUE_ROWS;
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
  const int dd = D == 1 ? 1 : d;
  v += j_base;

  Entry ent;
  ent.load(params, pdots, d, code);

  T xr[VALUE_RPT][D];
  load_stripe<T, D, VALUE_RPT>(x1, n1, row0, dd, d, xr);
  T lo1 = T(0), hi1 = T(0);
  bool fin1 = false;
  if constexpr (SUPPORT)
    stripe_range<T, VALUE_RPT>(n1, row0, xr, lo1, hi1, fin1);
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < VALUE_RPT; ++i)
#pragma unroll
      for (int a = 0; a < D; ++a)
        xs1[a * VALUE_ROWS + lane + 32 * i] = xr[i][a];
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
    if constexpr (SUPPORT)
      n_kept = kept_tiles(list, flags, x2, cb, c_end, nt, lo1, hi1, fin1,
                          ent.t0());
    auto col = [&](int k) {
      return cb + (SUPPORT ? list[k] : k) * VALUE_COLS;
    };
    if (n_kept > 0)
      stage_wide<T, NB, D>(stages, x2, dd, d, v, ldv, wz, col(0), c_end);
    cp_async_commit();
    for (int k = 0; k < n_kept; ++k) {
      if (k + 1 < n_kept)
        stage_wide<T, NB, D>(stages + ((k + 1) & 1) * L::STAGE, x2, dd, d,
                             v, ldv, wz, col(k + 1), c_end);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile k staged by every thread; xs1 written
      const T* xs2 = stages + (k & 1) * L::STAGE;
      const T* vs = xs2 + L::XS;
      const int c0 = col(k);
      T xc[D];
#pragma unroll
      for (int a = 0; a < D; ++a) xc[a] = xs2[a * VALUE_COLS + lane];
      // evaluate the 64 x 32 tile: thread (warp, lane) rows warp + 8 u
#pragma unroll 2
      for (int u = 0; u < VALUE_ROWS / VALUE_WARPS; ++u) {
        const int r = warp + VALUE_WARPS * u;
        const bool ok = row0 + r < n1 && c0 + lane < c_end;
        T xa[D];
#pragma unroll
        for (int a = 0; a < D; ++a) xa[a] = xs1[a * VALUE_ROWS + r];
        T kv[1];
        ent(xa, xc, kv);
        ks[r * L::KS + lane] = ok ? kv[0] : T(0);
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
    if constexpr (SUPPORT) __syncthreads();
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
static int launch_value(Kernel fn, size_t smem, dim3 grid, int d, int code,
                        const T* params, const T* pdots, int m, const T* x1,
                        int n1, const T* x2, int n2, const T* v, int ldv,
                        int w, int seg_cols, int segs, T* part, T* out,
                        int ldo, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return launch_split<T>(
      [&](T* dst, int ldd, size_t seg_stride) {
        fn<<<grid, VALUE_THREADS, smem, stream>>>(d, code, params, pdots, m,
                                                  x1, n1, x2, n2, v, ldv, w,
                                                  seg_cols, dst, ldd,
                                                  seg_stride);
      },
      m, n1, w, segs, part, out, ldo, stream);
}

// The arguments of every launch below; pdots and m are the projection of
// a projecting entry (null and 1 otherwise).
#define VALUE_ARGS d, code, params, pdots, m, x1, n1, x2, n2, v, ldv, w, \
    seg_cols, segs, part, out, ldo, stream
#define VALUE_PARAMS int d, int code, const T *params, const T *pdots,    \
    int m, const T *x1, int n1, const T *x2, int n2, const T *v, int ldv, \
    int w, int seg_cols, int segs, T *part, T *out, int ldo,              \
    cudaStream_t stream

template <typename T, typename Entry, int B>
static int launch_narrow(VALUE_PARAMS) {
  constexpr int rows = 32 * narrow_rpt(Entry::NS, B);
  const dim3 grid((n1 + rows - 1) / rows, segs);
  return launch_value<T>(value_narrow_kernel<T, Entry, B>,
                         narrow_smem_bytes<T, Entry, B>(), grid, VALUE_ARGS);
}

template <typename T, typename Entry, int NB>
static int launch_wide(VALUE_PARAMS) {
  const dim3 grid((n1 + VALUE_ROWS - 1) / VALUE_ROWS, segs,
                  (w + 32 * NB - 1) / (32 * NB));
  return launch_value<T>(value_wide_kernel<T, Entry, NB>,
                         wide_smem_bytes<T, Entry, NB>(), grid, VALUE_ARGS);
}

// Narrow widths 1 (value-only CG), 4, 8 (Lanczos), 9 (the training CG's
// 1 + 8 probes) and 16; wide ones in 32, 64 or 128 columns per block.
// Each width is one more kernel per kind and type for nvcc to build, so
// the products of 3 and 4 factors, which no workflow path runs, take one
// narrow width (16) and one wide (128 columns), their tails masked.
template <typename T, int KIND>
static int launch_value_kind(VALUE_PARAMS) {
  using E = ValueEntry<T, KIND>;
  if constexpr (KIND == VALUE_PRODUCT4) {
    if (w <= VALUE_NARROW_MAX) return launch_narrow<T, E, 16>(VALUE_ARGS);
    return launch_wide<T, E, 4>(VALUE_ARGS);
  } else {
    if (w <= 1) return launch_narrow<T, E, 1>(VALUE_ARGS);
    if (w <= 4) return launch_narrow<T, E, 4>(VALUE_ARGS);
    if (w <= 8) return launch_narrow<T, E, 8>(VALUE_ARGS);
    if (w <= 9) return launch_narrow<T, E, 9>(VALUE_ARGS);
    if (w <= VALUE_NARROW_MAX) return launch_narrow<T, E, 16>(VALUE_ARGS);
    if (w <= 32) return launch_wide<T, E, 1>(VALUE_ARGS);
    if (w <= 64) return launch_wide<T, E, 2>(VALUE_ARGS);
    return launch_wide<T, E, 4>(VALUE_ARGS);
  }
}

// out (n1, ldo) = K(x1, x2) @ v[:, :w] (v (n2, ldv)) for one family; part:
// the (segs, n1, w) scratch, unused (may be null) when segs == 1.
template <typename T>
static int launch_value_sweep(int kind, const T* params, const T* x1, int n1,
                              const T* x2, int n2, const T* v, int ldv, int w,
                              int seg_cols, int segs, T* part, T* out,
                              int ldo, cudaStream_t stream) {
  if (n1 <= 0 || w <= 0 || w > VALUE_MAX_COLS ||
      !value_split_ok(n2, seg_cols, segs, part))
    return (int)cudaErrorInvalidValue;
  const int d = 1, code = 0, m = 1;
  const T* pdots = nullptr;
  return kind_switch(kind, [&](auto k) {
    return launch_value_kind<T, decltype(k)::value>(VALUE_ARGS);
  });
}

// The same for the separable product of d <= MAX_AXES families (code: the
// family of axis a in bits 4a, params (d, N_PARAM_SLOTS)) on x1 (n1, d)
// and x2 (n2, d).
template <typename T>
static int launch_value_product(int d, int code, const T* params,
                                const T* x1, int n1, const T* x2, int n2,
                                const T* v, int ldv, int w, int seg_cols,
                                int segs, T* part, T* out, int ldo,
                                cudaStream_t stream) {
  if (d < 1 || d > MAX_AXES || n1 <= 0 || w <= 0 || w > VALUE_MAX_COLS ||
      !value_split_ok(n2, seg_cols, segs, part))
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < d; ++a)
    if (axis_kind(code, a) > MATERN52) return (int)cudaErrorInvalidValue;
  const int m = 1;
  const T* pdots = nullptr;
  if (d <= 2) return launch_value_kind<T, VALUE_PRODUCT2>(VALUE_ARGS);
  return launch_value_kind<T, VALUE_PRODUCT4>(VALUE_ARGS);
}

#undef VALUE_ARGS
#undef VALUE_PARAMS

}  // namespace tile
