// What every tile kernel shares: the family ids, the parameter layout and
// the Wendland factor.  The entries themselves (k and its gradient) are in
// value_sweep.cuh and tangent_sweep.cuh; B1-B4, B8, B9, B12 and B13 all
// take theirs from there.
//
// The parameter vector p is the padded natural-scale block (N_PARAM_SLOTS
// = 8): k1 = (T0, T1, l1), k2 = (T0, T1, l1, T2, l2), se / matern* =
// (ell,), as in repro_torch/kernels/ref.py.  The sine argument keeps the
// reference's order (pi * dt) / T1: the smallest admissible timescale is
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

}  // namespace tile
