// B9: the m stacked tangents of a separable product kernel,
// out[i] = (sum_a (sum_s pdots[i, a, s] dk_a/dp[s]) prod_{b != a} k_b) @ V.
//
// Replaces matvec_stacked_tangent_pallas_nd (repro/kernels/
// kernel_matvec.py) and its body _matvec_stacked_tangent_kernel_nd, which
// applies the product rule through jax.linearize inside the Pallas body.
// Here the rule is written out: each entry evaluates every factor's value
// and closed-form natural-slot gradient once (tile_grad in tile_fns.cuh),
// and each direction sums, over the axes, its gradient contraction on one
// axis times the other axes' values.  The sweep is tile_sweep_nd_kernel in
// tangent mode (tile_sweep_nd.cuh).  Plain C interface for ctypes, as in
// tile_matvec_nd.cu.
#include "tile_sweep_nd.cuh"

// part: the (segs, m, n1, b) scratch, unused (may be null) when segs == 1.
extern "C" int tile_tangent_nd_f64(int d, int kinds_code, const void* params,
                                   const void* pdots, int m, const void* x1,
                                   int n1, const void* x2, int n2,
                                   const void* v, int ldv, int b,
                                   int seg_cols, int segs, void* part,
                                   void* out, int ldo, void* stream) {
  return tile::launch_sweep_nd<double, true>(
      d, kinds_code, (const double*)params, (const double*)pdots, m,
      (const double*)x1, n1, (const double*)x2, n2, (const double*)v, ldv, b,
      seg_cols, segs, (double*)part, (double*)out, ldo,
      (cudaStream_t)stream);
}

extern "C" int tile_tangent_nd_f32(int d, int kinds_code, const void* params,
                                   const void* pdots, int m, const void* x1,
                                   int n1, const void* x2, int n2,
                                   const void* v, int ldv, int b,
                                   int seg_cols, int segs, void* part,
                                   void* out, int ldo, void* stream) {
  return tile::launch_sweep_nd<float, true>(
      d, kinds_code, (const float*)params, (const float*)pdots, m,
      (const float*)x1, n1, (const float*)x2, n2, (const float*)v, ldv, b,
      seg_cols, segs, (float*)part, (float*)out, ldo, (cudaStream_t)stream);
}
