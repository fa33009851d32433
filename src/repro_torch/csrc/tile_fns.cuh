// Covariance tile formulas k(dt; p) (B4's tile_matrix.cu; the value and
// tangent sweeps take their own forms, value_sweep.cuh, tangent_sweep.cuh).
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
constexpr int MAX_DIRS_ND = 10;  // product tangent directions per launch

// The separable product kinds (B8, B9, B13): at most MAX_AXES factors,
// the family of axis a in bits 4a .. 4a + 3 of a packed code.
constexpr int MAX_AXES = 4;

__host__ __device__ inline int axis_kind(int code, int a) {
  return (code >> (4 * a)) & 15;
}

// The natural slots a family's tile depends on.
__host__ __device__ constexpr int family_slots(int kind) {
  return kind == K1 ? 3 : (kind == K2 ? 5 : 1);
}

template <int KIND>
__host__ __device__ constexpr int kind_slots() {
  return family_slots(KIND);
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

}  // namespace tile
