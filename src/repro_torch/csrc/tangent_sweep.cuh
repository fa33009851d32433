// The tangent sweeps B2 and B3 on the value sweep's kernels
// (value_sweep.cuh):
//
//   B2  out[i] = (sum_s pdots[i, s] dK/dp[s])(x1, x2) @ V,  i < m <= 5,
//   B3  out    = (sum_s pdot[s] dK/dp[s])(x1, x2) @ V       (one direction).
//
// Replaces _matvec_stacked_tangent_kernel and _matvec_tangent_kernel of
// repro/kernels/kernel_matvec.py, which linearise the tile inside the
// kernel.  Here each entry evaluates k's closed-form gradient over the
// kind's NS natural slots (NS = 5 for k2, 3 for k1, 1 for se and Matern;
// the formulas of tile_grad in tile_fns.cuh) and the value sweep's kernels
// contract it with V in registers:
//
// - B2 at b <= VALUE_NARROW_MAX (the workflow's b = 9) runs
//   value_narrow_kernel on GradEntry: each entry's NS gradient values are
//   multiply-added into NS x B register accumulators per row,
//   acc[s][j] += g[s] V[c, j], whatever m is, and the stripe's NS slot sums
//   are projected on pdots once per output row as they are written,
//   out[i, r, j] = sum_s pdots[i, s] acc[s][r, j].  That is exact for any
//   pdots, and spends no m NS projection per entry (25 FMAs at k2, m = 5).
//   With NS b > 16 accumulators a lane owns one row of a 32-row stripe
//   (narrow_rpt); up to 45 (k2 at b = 9) the kernel still runs two blocks
//   per SM under 128 registers and spills a few cold values of the
//   evaluation, which beat one block per SM with every value in registers
//   and splitting V's columns over launches (narrow_blocks, PERF.md).
//   A wider V (b > 16, off the workflow's path) takes one launch per 16
//   columns, each evaluating the gradient again.
// - B3 runs JvpEntry, the one value pdot . grad k per entry projected in
//   registers, on value_narrow_kernel at b <= 16 (64-row stripes, as B1)
//   and on value_wide_kernel (fp64 mma.sync, 128 columns per block) above.
//
// Both inherit the value sweep's Wendland-support skip for k1 and k2: a
// block lists the column tiles within T0 of its stripe (kept_tiles) and
// evaluates only those, and inside a kept tile an entry with a finite
// |dt| >= T0 is 0 before any sincos or exp.  The skip is exact for the
// gradient too: there w = dW/dT0 = 0, so every slot is 0 (k times a
// factor, or dW/dT0 times the periodic factor), as in the plain version;
// a stripe or tile beyond +-VALUE_BIG, or with a nan, skips nothing.
//
// Operation order: the sine arguments stay (pi * dt) / T (tile_fns.cuh);
// every other division (by T0, T1, T2, l1, l2 or the lengthscale) is a
// product with a reciprocal taken once per block (grad_consts).  No
// atomics: the warps' and segments' partial sums meet in a fixed order.
#pragma once

#include "value_sweep.cuh"

namespace tile {

// q: the reciprocals grad_entry multiplies by; k1/k2 (1/T0, 1/T1, 1/l1,
// 1/T2, 1/l2), the others (1/ell).
template <typename T, int KIND>
__device__ __forceinline__ void grad_consts(const T* p, T* q) {
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s) q[s] = T(0);
  if (KIND == K1 || KIND == K2) {
    q[0] = T(1) / p[0];
    q[1] = T(1) / p[1];
    q[2] = T(1) / p[2];
    if (KIND == K2) {
      q[3] = T(1) / p[3];
      q[4] = T(1) / p[4];
    }
  } else {
    q[0] = T(1) / p[0];
  }
}

// g[s] = dk/dp[s] for the kind's natural slots (tile_grad's formulas), 0
// before any sincos or exp where the Wendland factor is 0: a finite
// |dt| >= T0.  A nan or inf dt takes the full formula, which gives the
// plain version's nan.
template <typename T, int KIND>
__device__ __forceinline__ void grad_entry(T dt, const T* p, const T* q,
                                           T (&g)[kind_slots<KIND>()]) {
  const T pi = T(3.141592653589793);
  if constexpr (KIND == K1 || KIND == K2) {
    const T adt = fabs(dt);
    if (adt >= p[0] && isfinite(adt)) {
#pragma unroll
      for (int s = 0; s < kind_slots<KIND>(); ++s) g[s] = T(0);
      return;
    }
    // W(tau) and dW/dT0 = W'(tau) (-tau / T0), tau = |dt| / T0; both 0 at
    // tau >= 1
    const T tau = adt * q[0];
    T w = T(0), dw = T(0);
    if (tau < T(1)) {
      const T om = T(1) - tau;
      const T om2 = om * om;
      const T om4 = om2 * om2;
      w = om * om4 * (T(8) * tau * tau + T(5) * tau + T(1));
      dw = (T(-14) * tau * om4 * (T(4) * tau + T(1))) * (-tau * q[0]);
    }
    // s = sin(a) / l and ds/dT = cos(a) (-a / T) / l, a = (pi dt) / T
    const T a1 = pi * dt / p[1];
    T sa1, ca1;
    sincos(a1, &sa1, &ca1);
    const T s1 = sa1 * q[2];
    const T ds1 = ca1 * (-a1 * q[1]) * q[2];
    T s2 = T(0), ds2 = T(0);
    if constexpr (KIND == K2) {
      const T a2 = pi * dt / p[3];
      T sa2, ca2;
      sincos(a2, &sa2, &ca2);
      s2 = sa2 * q[4];
      ds2 = ca2 * (-a2 * q[3]) * q[4];
    }
    const T per = KIND == K2 ? exp(T(-2) * (s1 * s1 + s2 * s2))
                             : exp(T(-2) * s1 * s1);
    const T k = w * per;
    g[0] = dw * per;
    g[1] = k * (T(-4) * s1 * ds1);
    g[2] = k * (T(4) * s1 * s1 * q[2]);
    if constexpr (KIND == K2) {
      g[3] = k * (T(-4) * s2 * ds2);
      g[4] = k * (T(4) * s2 * s2 * q[4]);
    }
  } else if constexpr (KIND == SE) {
    const T r = dt * q[0];
    const T k = exp(T(-0.5) * r * r);
    g[0] = k * r * r * q[0];
  } else if constexpr (KIND == MATERN12) {
    const T a = fabs(dt) * q[0];
    g[0] = exp(-a) * a * q[0];
  } else if constexpr (KIND == MATERN32) {
    const T a = sqrt(T(3)) * fabs(dt) * q[0];
    g[0] = a * a * exp(-a) * q[0];
  } else {
    const T a = sqrt(T(5)) * fabs(dt) * q[0];
    g[0] = a * a * (T(1) + a) * T(1.0 / 3.0) * exp(-a) * q[0];
  }
}

// B2's entry: the kind's NS gradient values, projected by the kernel.
template <typename T, int KIND>
struct GradEntry {
  static constexpr int D = 1;
  static constexpr int NS = kind_slots<KIND>();
  static constexpr bool PROJECT = true;
  static constexpr bool SUPPORT = has_support<KIND>();
  T p[MAX_SLOTS], q[MAX_SLOTS];
  __device__ __forceinline__ void load(const T* __restrict__ params,
                                       const T*, int, int) {
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) p[s] = params[s];
    grad_consts<T, KIND>(p, q);
  }
  __device__ __forceinline__ T t0() const { return p[0]; }
  __device__ __forceinline__ void operator()(const T (&x1)[1],
                                             const T (&x2)[1],
                                             T (&g)[NS]) const {
    grad_entry<T, KIND>(x1[0] - x2[0], p, q, g);
  }
};

// B3's entry: pdot . grad k, one value per entry.
template <typename T, int KIND>
struct JvpEntry {
  static constexpr int D = 1;
  static constexpr int NS = 1;
  static constexpr bool PROJECT = false;
  static constexpr bool SUPPORT = has_support<KIND>();
  static constexpr int SLOTS = kind_slots<KIND>();
  T p[MAX_SLOTS], q[MAX_SLOTS], pd[SLOTS];
  __device__ __forceinline__ void load(const T* __restrict__ params,
                                       const T* __restrict__ pdot, int,
                                       int) {
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) p[s] = params[s];
    grad_consts<T, KIND>(p, q);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) pd[s] = pdot[s];
  }
  __device__ __forceinline__ T t0() const { return p[0]; }
  __device__ __forceinline__ void operator()(const T (&x1)[1],
                                             const T (&x2)[1],
                                             T (&out)[1]) const {
    T g[SLOTS];
    grad_entry<T, KIND>(x1[0] - x2[0], p, q, g);
    T t = T(0);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) t += pd[s] * g[s];
    out[0] = t;
  }
};

// The narrow widths of both sweeps: 1 (alpha), 8 (Lanczos, probes), 9
// (the training CG's 1 + 8 probes) and 16; a launch takes the smallest
// that holds its width and masks the tail.
__host__ __device__ constexpr int tangent_width(int w) {
  return w <= 1 ? 1 : (w <= 8 ? 8 : (w <= 9 ? 9 : 16));
}

#define TANGENT_ARGS d, code, params, pdots, m, x1, n1, x2, n2, v, ldv, w, \
    seg_cols, segs, part, out, ldo, stream

template <typename T, typename Entry>
static int launch_tangent_narrow(int d, int code, const T* params,
                                 const T* pdots, int m, const T* x1, int n1,
                                 const T* x2, int n2, const T* v, int ldv,
                                 int w, int seg_cols, int segs, T* part,
                                 T* out, int ldo, cudaStream_t stream) {
  switch (tangent_width(w)) {
    case 1: return launch_narrow<T, Entry, 1>(TANGENT_ARGS);
    case 8: return launch_narrow<T, Entry, 8>(TANGENT_ARGS);
    case 9: return launch_narrow<T, Entry, 9>(TANGENT_ARGS);
    default: return launch_narrow<T, Entry, 16>(TANGENT_ARGS);
  }
}

// Rows per stripe of B2's kernel for family kind at width w (the wrapper's
// grid; above VALUE_NARROW_MAX those of its 16-column launches).
inline int tangent_rows(int kind, int w) {
  const int b = tangent_width(w);
  return kind_switch(kind, [&](auto k) {
    return 32 * narrow_rpt(kind_slots<decltype(k)::value>(), b);
  });
}

// B2: out (m, n1, ldo) = (sum_s pdots[i, s] dK/dp[s]) @ v[:, :w] for
// i < m <= MAX_DIRS, pdots (m, N_PARAM_SLOTS), one launch per
// VALUE_NARROW_MAX columns of V in order; part: the (segs, m, n1,
// min(w, VALUE_NARROW_MAX)) scratch, unused (may be null) when segs == 1;
// seg_cols a multiple of the 32-column tile.
template <typename T>
static int launch_tangent_sweep(int kind, const T* params, const T* pdots,
                                int m, const T* x1, int n1, const T* x2,
                                int n2, const T* v, int ldv, int w,
                                int seg_cols, int segs, T* part, T* out,
                                int ldo, cudaStream_t stream) {
  if (n1 <= 0 || w <= 0 || w > VALUE_MAX_COLS || m < 1 || m > MAX_DIRS ||
      !value_split_ok(n2, seg_cols, segs, part))
    return (int)cudaErrorInvalidValue;
  const int d = 1, code = 0;
  for (int j0 = 0; j0 < w; j0 += VALUE_NARROW_MAX) {
    const int err = kind_switch(kind, [&](auto k) {
      return launch_tangent_narrow<T, GradEntry<T, decltype(k)::value>>(
          d, code, params, pdots, m, x1, n1, x2, n2, v + j0, ldv,
          min(VALUE_NARROW_MAX, w - j0), seg_cols, segs, part, out + j0, ldo,
          stream);
    });
    if (err) return err;
  }
  return 0;
}

// B3: out (n1, ldo) = (sum_s pdot[s] dK/dp[s]) @ v[:, :w], pdot
// (N_PARAM_SLOTS,), m = 1; part: the (segs, n1, w) scratch, unused (may be
// null) when segs == 1; seg_cols a multiple of the 32-column tile.
template <typename T>
static int launch_jvp_sweep(int kind, const T* params, const T* pdots, int m,
                            const T* x1, int n1, const T* x2, int n2,
                            const T* v, int ldv, int w, int seg_cols,
                            int segs, T* part, T* out, int ldo,
                            cudaStream_t stream) {
  if (n1 <= 0 || w <= 0 || w > VALUE_MAX_COLS || m != 1 ||
      !value_split_ok(n2, seg_cols, segs, part))
    return (int)cudaErrorInvalidValue;
  const int d = 1, code = 0;
  return kind_switch(kind, [&](auto k) {
    using E = JvpEntry<T, decltype(k)::value>;
    if (w <= VALUE_NARROW_MAX)
      return launch_tangent_narrow<T, E>(TANGENT_ARGS);
    return launch_wide<T, E, 4>(TANGENT_ARGS);
  });
}

#undef TANGENT_ARGS

}  // namespace tile
