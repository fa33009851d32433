// Covariance tile formulas k(dt; p) and their natural-parameter gradients.
//
// Device-side twin of repro_torch/kernels/ref.py.  The parameter vector p is
// the padded natural-scale block (N_PARAM_SLOTS = 8): k1 = (T0, T1, l1),
// k2 = (T0, T1, l1, T2, l2), se / matern* = (ell,).
//
// The operation order follows the reference tile functions exactly, in
// particular sin((pi * dt) / T1) / l1: the smallest admissible timescale is
// the smallest data gap, so (pi * dt) / T1 can reach 1e8-1e9 and any
// reordering of that argument shows above 1e-12.  sin/cos run in full
// double precision with CUDA's own range reduction (no fast-math).
#pragma once

#include <cuda_runtime.h>

namespace tile {

enum Kind { K1 = 0, K2 = 1, SE = 2, MATERN12 = 3, MATERN32 = 4, MATERN52 = 5 };

constexpr int N_PARAM_SLOTS = 8;
constexpr int MAX_SLOTS = 5;   // natural slots that carry a derivative (k2)
constexpr int MAX_DIRS = 5;    // tangent directions per launch (k2: m = 5)

template <int KIND>
__host__ __device__ constexpr int kind_slots() {
  return KIND == K1 ? 3 : (KIND == K2 ? 5 : 1);
}

// (1 - tau)^5 as x * (x^2)^2: the multiplication order of lax.integer_pow.
template <typename T>
__device__ __forceinline__ T pow5(T a) {
  T a2 = a * a;
  T a4 = a2 * a2;
  return a * a4;
}

// Wendland phi_{3,2}(|u|); 0 at |u| >= 1 (value and derivative).
template <typename T>
__device__ __forceinline__ T wendland(T u) {
  T tau = fabs(u);
  if (!(tau < T(1))) return T(0);
  return pow5(T(1) - tau) * (T(8) * tau * tau + T(5) * tau + T(1));
}

template <typename T, int KIND>
__device__ __forceinline__ T tile_value(T dt, const T* p) {
  const T pi = T(3.141592653589793);
  if (KIND == K1) {
    T s1 = sin(pi * dt / p[1]) / p[2];
    return wendland(dt / p[0]) * exp(T(-2) * s1 * s1);
  } else if (KIND == K2) {
    T s1 = sin(pi * dt / p[1]) / p[2];
    T s2 = sin(pi * dt / p[3]) / p[4];
    return wendland(dt / p[0]) * exp(T(-2) * (s1 * s1 + s2 * s2));
  } else if (KIND == SE) {
    T r = dt / p[0];
    return exp(T(-0.5) * r * r);
  } else if (KIND == MATERN12) {
    return exp(-fabs(dt) / p[0]);
  } else if (KIND == MATERN32) {
    T a = sqrt(T(3)) * fabs(dt) / p[0];
    return (T(1) + a) * exp(-a);
  } else {
    T a = sqrt(T(5)) * fabs(dt) / p[0];
    return (T(1) + a + a * a / T(3)) * exp(-a);
  }
}

// Wendland value and derivative in tau = |dt| / T0, times d tau / d T0:
// W'(tau) = -14 tau (1 - tau)^4 (4 tau + 1) for tau < 1, else 0, and
// d tau / d T0 = -tau / T0.
template <typename T>
__device__ __forceinline__ void wendland_grad(T dt, T t0, T* w, T* dw_dt0) {
  T tau = fabs(dt / t0);
  if (!(tau < T(1))) {
    *w = T(0);
    *dw_dt0 = T(0);
    return;
  }
  T om = T(1) - tau;
  T om2 = om * om;
  T om4 = om2 * om2;
  *w = om * om4 * (T(8) * tau * tau + T(5) * tau + T(1));
  *dw_dt0 = (T(-14) * tau * om4 * (T(4) * tau + T(1))) * (-tau / t0);
}

// Periodic factor pieces for one (T, l) pair: s = sin(a) / l with
// a = (pi dt) / T, and ds/dT = cos(a) (-a / T) / l.
template <typename T>
__device__ __forceinline__ void periodic_grad(T dt, T period, T ell, T* s,
                                              T* ds_dt) {
  const T pi = T(3.141592653589793);
  T a = pi * dt / period;
  T sa, ca;
  sincos(a, &sa, &ca);
  *s = sa / ell;
  *ds_dt = ca * (-a / period) / ell;
}

// k(dt) and g[s] = dk / dp[s] for the kind's natural slots s < kind_slots.
template <typename T, int KIND>
__device__ __forceinline__ T tile_grad(T dt, const T* p, T* g) {
  if (KIND == K1 || KIND == K2) {
    T w, dw;
    wendland_grad(dt, p[0], &w, &dw);
    T s1, ds1;
    periodic_grad(dt, p[1], p[2], &s1, &ds1);
    T s2 = T(0), ds2 = T(0);
    if (KIND == K2) periodic_grad(dt, p[3], p[4], &s2, &ds2);
    T per = KIND == K2 ? exp(T(-2) * (s1 * s1 + s2 * s2))
                       : exp(T(-2) * s1 * s1);
    T k = w * per;
    g[0] = dw * per;
    g[1] = k * (T(-4) * s1 * ds1);
    g[2] = k * (T(4) * s1 * s1 / p[2]);
    if (KIND == K2) {
      g[3] = k * (T(-4) * s2 * ds2);
      g[4] = k * (T(4) * s2 * s2 / p[4]);
    }
    return k;
  } else if (KIND == SE) {
    T r = dt / p[0];
    T k = exp(T(-0.5) * r * r);
    g[0] = k * r * r / p[0];
    return k;
  } else if (KIND == MATERN12) {
    T a = fabs(dt) / p[0];
    T k = exp(-fabs(dt) / p[0]);
    g[0] = k * a / p[0];
    return k;
  } else if (KIND == MATERN32) {
    T a = sqrt(T(3)) * fabs(dt) / p[0];
    T e = exp(-a);
    g[0] = a * a * e / p[0];
    return (T(1) + a) * e;
  } else {
    T a = sqrt(T(5)) * fabs(dt) / p[0];
    T e = exp(-a);
    g[0] = a * a * (T(1) + a) / T(3) * e / p[0];
    return (T(1) + a + a * a / T(3)) * e;
  }
}

}  // namespace tile
