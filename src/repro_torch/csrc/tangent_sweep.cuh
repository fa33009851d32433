// The tangent sweeps B2, B3 and B9 on the value sweep's kernels
// (value_sweep.cuh):
//
//   B2  out[i] = (sum_s pdots[i, s] dK/dp[s])(x1, x2) @ V,  i < m <= 5,
//   B3  out    = (sum_s pdot[s] dK/dp[s])(x1, x2) @ V       (one direction),
//   B9  out[i] = (sum_a (sum_s pdots[i, a, s] dk_a/dp[s]) prod_{b != a} k_b)
//                (x1, x2) @ V on (n, d) coordinates,        i < m <= 10.
//
// Replaces _matvec_stacked_tangent_kernel, _matvec_tangent_kernel and
// _matvec_stacked_tangent_kernel_nd of repro/kernels/kernel_matvec.py,
// which linearise the tile inside the kernel.  Here each entry evaluates
// k's closed-form gradient over the kind's NS natural slots (NS = 5 for
// k2, 3 for k1, 1 for se and Matern; the formulas of tile_grad in
// kernels/ref.py) and the value sweep's kernels contract it with V in
// registers:
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
// - B9 runs ProductGradEntry on value_narrow_kernel the way B2 runs
//   GradEntry: each entry evaluates every factor's value and gradient
//   once (the families a run-time switch, as the product value entry's),
//   gives the slot values dk_a/dp[s] prod_{b != a} k_b, and the slot sums
//   are projected on pdots (m, d, 8) once per output row.  The slot count
//   is a template parameter, so that the accumulators are registers: the
//   entry takes d <= 2 or <= MAX_AXES axes of SA slots each, SA the most
//   any factor has (1 for se and Matern, 3 for k1, 5 for k2; a factor
//   with fewer slots leaves the rest 0).  The main path's two one-slot
//   factors ("se*matern32") make NS = 2, the accumulators of B2's "se" at
//   twice the width (18 at b = 9), on B2's widths 1, 8, 9, 16.  A larger
//   NS takes one width, the widest that keeps NS x width <= 48
//   (product_tangent_cols: 9 columns at NS = 4, 8 at 6, 4 at 10 and 12,
//   2 at 20), and one launch per that many columns.
//
// B2 and B3 inherit the value sweep's Wendland-support skip for k1 and
// k2: a block lists the column tiles within T0 of its stripe
// (kept_tiles) and evaluates only those, and inside a kept tile an entry
// with a finite |dt| >= T0 is 0 before any sincos or exp.  The skip is
// exact for the gradient too: there w = dW/dT0 = 0, so every slot is 0
// (k times a factor, or dW/dT0 times the periodic factor), as in the
// plain version; a stripe or tile beyond +-VALUE_BIG, or with a nan, skips
// nothing.  B9 skips no tile (nor does the product's value), but a k1 or
// k2 factor outside its window makes the whole entry 0, every slot and
// every other factor included, before any sincos or exp: each slot is a
// product with that factor's value or gradient, both 0 there.
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

// g[s] = dk/dp[s] for the kind's natural slots (the formulas of tile_grad
// in kernels/ref.py), and k itself as the return value (B9 multiplies the
// other factors by it); 0 before any sincos or exp where the Wendland
// factor is 0: a finite |dt| >= T0.  A nan or inf dt takes the full
// formula, which gives the plain version's nan.
template <typename T, int KIND>
__device__ __forceinline__ T grad_entry(T dt, const T* p, const T* q,
                                        T (&g)[kind_slots<KIND>()]) {
  const T pi = T(3.141592653589793);
  if constexpr (KIND == K1 || KIND == K2) {
    const T adt = fabs(dt);
    if (adt >= p[0] && isfinite(adt)) {
#pragma unroll
      for (int s = 0; s < kind_slots<KIND>(); ++s) g[s] = T(0);
      return T(0);
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
    return k;
  } else if constexpr (KIND == SE) {
    const T r = dt * q[0];
    const T k = exp(T(-0.5) * r * r);
    g[0] = k * r * r * q[0];
    return k;
  } else if constexpr (KIND == MATERN12) {
    const T a = fabs(dt) * q[0];
    const T e = exp(-a);
    g[0] = e * a * q[0];
    return e;
  } else if constexpr (KIND == MATERN32) {
    const T a = sqrt(T(3)) * fabs(dt) * q[0];
    const T e = exp(-a);
    g[0] = a * a * e * q[0];
    return (T(1) + a) * e;
  } else {
    const T a = sqrt(T(5)) * fabs(dt) * q[0];
    const T e = exp(-a);
    g[0] = a * a * (T(1) + a) * T(1.0 / 3.0) * e * q[0];
    return (T(1) + a + a * a / T(3)) * e;
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
  // slot s's coefficient in direction i: pdots (m, N_PARAM_SLOTS)
  __device__ __forceinline__ T coef(const T* __restrict__ pdots, int i,
                                    int s) const {
    return pdots[i * N_PARAM_SLOTS + s];
  }
  __device__ __forceinline__ void operator()(const T (&x1)[1],
                                             const T (&x2)[1],
                                             T (&g)[NS]) const {
    grad_entry<T, KIND>(x1[0] - x2[0], p, q, g);
  }
};

// One product factor's value k_a(dt) and its gradient over the family's
// natural slots into g[0 .. slots) (0 above them), the family a
// warp-uniform run-time value; SA >= the family's slot count.
template <typename T, int SA>
__device__ __forceinline__ T axis_grad(int kind, T dt, const T* p,
                                       const T* q, T (&g)[SA]) {
#pragma unroll
  for (int s = 0; s < SA; ++s) g[s] = T(0);
  T k = T(0);
  auto run = [&](auto fam) {
    constexpr int KIND = decltype(fam)::value;
    if constexpr (kind_slots<KIND>() <= SA) {
      T gk[kind_slots<KIND>()];
      k = grad_entry<T, KIND>(dt, p, q, gk);
#pragma unroll
      for (int s = 0; s < kind_slots<KIND>(); ++s) g[s] = gk[s];
    }
  };
  switch (kind) {
    case K1: run(std::integral_constant<int, K1>()); break;
    case K2: run(std::integral_constant<int, K2>()); break;
    case SE: run(std::integral_constant<int, SE>()); break;
    case MATERN12: run(std::integral_constant<int, MATERN12>()); break;
    case MATERN32: run(std::integral_constant<int, MATERN32>()); break;
    default: run(std::integral_constant<int, MATERN52>()); break;
  }
  return k;
}

// B9's entry: the product rule on d <= DIMS factors, slot (a, t) =
// a SA + t holding dk_a/dp[t] prod_{b != a} k_b for t below axis a's
// family slots (0 above them: SA is the most any axis has, 1, 3 or 5);
// params (d, N_PARAM_SLOTS), pdots (m, d, N_PARAM_SLOTS).  A k1 or k2
// factor outside its Wendland window (a finite |dt| >= T0) makes the
// whole entry 0, every slot included, before any factor's sincos or exp;
// a pair with a nan or inf difference on any axis takes the full formula.
template <typename T, int DIMS, int SA>
struct ProductGradEntry {
  static constexpr int D = DIMS;
  static constexpr int NS = DIMS * SA;
  static constexpr bool PROJECT = true;
  static constexpr bool SUPPORT = false;
  T p[D][MAX_SLOTS], q[D][MAX_SLOTS];
  int d, code;
  __device__ __forceinline__ void load(const T* __restrict__ params,
                                       const T*, int d_, int code_) {
    d = d_;
    code = code_;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const T* pa = params + (a < d ? a : 0) * N_PARAM_SLOTS;
#pragma unroll
      for (int s = 0; s < MAX_SLOTS; ++s) p[a][s] = pa[s];
      const int kind = a < d ? axis_kind(code, a) : SE;
      if (kind == K1)
        grad_consts<T, K1>(p[a], q[a]);
      else if (kind == K2)
        grad_consts<T, K2>(p[a], q[a]);
      else
        grad_consts<T, SE>(p[a], q[a]);
    }
  }
  __device__ __forceinline__ T t0() const { return T(0); }
  __device__ __forceinline__ T coef(const T* __restrict__ pdots, int i,
                                    int s) const {
    const int a = s / SA;
    const int t = s % SA;
    if (a >= d || t >= family_slots(axis_kind(code, a))) return T(0);
    return pdots[(i * d + a) * N_PARAM_SLOTS + t];
  }
  __device__ __forceinline__ void operator()(const T (&x1)[D],
                                             const T (&x2)[D],
                                             T (&g)[NS]) const {
    T dt[D];
    bool fin = true, outside = false;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      dt[a] = x1[a] - x2[a];
      if (a < d) {
        const int kind = axis_kind(code, a);
        fin = fin && isfinite(dt[a]);
        outside = outside ||
                  ((kind == K1 || kind == K2) && fabs(dt[a]) >= p[a][0]);
      }
    }
    if (outside && fin) {
#pragma unroll
      for (int s = 0; s < NS; ++s) g[s] = T(0);
      return;
    }
    T kv[D], gv[D][SA];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      if (a < d) {
        kv[a] = axis_grad<T, SA>(axis_kind(code, a), dt[a], p[a], q[a],
                                 gv[a]);
      } else {
        kv[a] = T(1);
#pragma unroll
        for (int t = 0; t < SA; ++t) gv[a][t] = T(0);
      }
    }
    // the other factors in axis order, as the plain version multiplies them
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T others = T(1);
#pragma unroll
      for (int b = 0; b < D; ++b)
        if (b != a) others *= kv[b];
#pragma unroll
      for (int t = 0; t < SA; ++t) g[a * SA + t] = gv[a][t] * others;
    }
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

// B9's columns per launch for ns slots: 16 (its narrow widths 1, 8, 9
// and 16, tangent_width) at ns = 2, the main path's two one-slot factors;
// above, one width each, the widest of 9, 8, 4, 2 that keeps a row's
// ns x width accumulators <= 48.
__host__ __device__ constexpr int product_tangent_cols(int ns) {
  return ns <= 2 ? VALUE_NARROW_MAX
                 : (ns * 9 <= 48 ? 9
                                 : (ns * 8 <= 48 ? 8 : (ns * 4 <= 48 ? 4 : 2)));
}

// The narrow width B9 takes for w <= product_tangent_cols(ns) columns.
__host__ __device__ constexpr int product_tangent_width(int ns, int w) {
  return ns <= 2 ? tangent_width(w) : product_tangent_cols(ns);
}

// (DIMS, SA) of B9's entry for d factors of the packed families code: D 2
// or MAX_AXES, SA the most slots any factor has.
inline void product_tangent_shape(int d, int code, int* dims, int* sa) {
  *dims = d <= 2 ? 2 : MAX_AXES;
  *sa = 1;
  for (int a = 0; a < d; ++a) {
    const int ns = family_slots(axis_kind(code, a));
    if (ns > *sa) *sa = ns;
  }
}

// Rows per stripe of B9's kernel at width w (the wrapper's grid; above its
// columns per launch those of each launch).
inline int product_tangent_rows(int d, int code, int w) {
  int dims, sa;
  product_tangent_shape(d, code, &dims, &sa);
  const int ns = dims * sa;
  const int cols = product_tangent_cols(ns);
  return 32 * narrow_rpt(ns, product_tangent_width(ns, w < cols ? w : cols));
}

template <typename T, int DIMS, int SA>
static int launch_product_tangent_chunk(int d, int code, const T* params,
                                        const T* pdots, int m, const T* x1,
                                        int n1, const T* x2, int n2,
                                        const T* v, int ldv, int w,
                                        int seg_cols, int segs, T* part,
                                        T* out, int ldo,
                                        cudaStream_t stream) {
  using E = ProductGradEntry<T, DIMS, SA>;
  if constexpr (E::NS <= 2) {
    return launch_tangent_narrow<T, E>(TANGENT_ARGS);
  } else {
    return launch_narrow<T, E, product_tangent_cols(E::NS)>(TANGENT_ARGS);
  }
}

// B9: out (m, n1, ldo) = the m product-rule tangents of the separable
// product of d <= MAX_AXES families (code: axis a's family in bits 4a)
// @ v[:, :w], params (d, N_PARAM_SLOTS), pdots (m, d, N_PARAM_SLOTS),
// m <= MAX_DIRS_ND, x1 (n1, d), x2 (n2, d); one launch per
// product_tangent_cols columns of V in order; part: the (segs, m, n1,
// min(w, cols)) scratch, unused (may be null) when segs == 1; seg_cols a
// multiple of the 32-column tile.
template <typename T>
static int launch_product_tangent_sweep(int d, int code, const T* params,
                                        const T* pdots, int m, const T* x1,
                                        int n1, const T* x2, int n2,
                                        const T* v, int ldv, int w,
                                        int seg_cols, int segs, T* part,
                                        T* out, int ldo,
                                        cudaStream_t stream) {
  if (d < 1 || d > MAX_AXES || n1 <= 0 || w <= 0 || w > VALUE_MAX_COLS ||
      m < 1 || m > MAX_DIRS_ND || !value_split_ok(n2, seg_cols, segs, part))
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < d; ++a)
    if (axis_kind(code, a) > MATERN52) return (int)cudaErrorInvalidValue;
  int dims, sa;
  product_tangent_shape(d, code, &dims, &sa);
  const int cols = product_tangent_cols(dims * sa);
  for (int j0 = 0; j0 < w; j0 += cols) {
    const int wc = min(cols, w - j0);
    auto chunk = [&](auto launch) {
      return launch(d, code, params, pdots, m, x1, n1, x2, n2, v + j0, ldv,
                    wc, seg_cols, segs, part, out + j0, ldo, stream);
    };
    int err;
    if (dims == 2)
      err = sa == 1   ? chunk(launch_product_tangent_chunk<T, 2, 1>)
            : sa == 3 ? chunk(launch_product_tangent_chunk<T, 2, 3>)
                      : chunk(launch_product_tangent_chunk<T, 2, 5>);
    else
      err = sa == 1   ? chunk(launch_product_tangent_chunk<T, MAX_AXES, 1>)
            : sa == 3 ? chunk(launch_product_tangent_chunk<T, MAX_AXES, 3>)
                      : chunk(launch_product_tangent_chunk<T, MAX_AXES, 5>);
    if (err) return err;
  }
  return 0;
}

#undef TANGENT_ARGS

}  // namespace tile
