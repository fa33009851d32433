// B3: the tangent matvec of one natural-parameter direction
//   out = (sum_s pdot[s] dK/dp[s])(x1, x2) @ V,
// the forward-mode rule of the covariance matvec (kernels/ops.matvec_jvp).
//
// Replaces matvec_tangent_pallas (repro/kernels/kernel_matvec.py) and its
// body _matvec_tangent_kernel, which takes jax.jvp of the tile inside the
// kernel.  Here each entry evaluates the closed-form gradient of k over the
// kind's natural slots (tile_grad in tile_fns.cuh, the derivatives B2
// uses) and projects it on pdot with one register dot product.  The sweep
// is tile_sweep_kernel in tangent mode with the direction count fixed at 1
// at compile time (tile_sweep.cuh): the grid of row stripes x column
// segments and the fixed-order segment reduce are B2's, so every run gives
// the same bits.  Plain C interface for ctypes, as in tile_matvec.cu; the
// signature is B2's with m = 1.
#include "tile_sweep.cuh"

extern "C" int tile_jvp_max_cols(int elem_bytes) {
  return tile::sweep_max_cols(1, (size_t)elem_bytes);
}

// pdot: (N_PARAM_SLOTS,) and m must be 1; part: the (segs, n1, b) scratch,
// unused (may be null) when segs == 1.
extern "C" int tile_jvp_f64(int kind, const void* params, const void* pdot,
                            int m, const void* x1, int n1, const void* x2,
                            int n2, const void* v, int ldv, int b,
                            int seg_cols, int segs, void* part, void* out,
                            int ldo, void* stream) {
  return tile::launch_sweep<double, 1>(
      kind, (const double*)params, (const double*)pdot, m,
      (const double*)x1, n1, (const double*)x2, n2, (const double*)v, ldv, b,
      seg_cols, segs, (double*)part, (double*)out, ldo,
      (cudaStream_t)stream);
}

extern "C" int tile_jvp_f32(int kind, const void* params, const void* pdot,
                            int m, const void* x1, int n1, const void* x2,
                            int n2, const void* v, int ldv, int b,
                            int seg_cols, int segs, void* part, void* out,
                            int ldo, void* stream) {
  return tile::launch_sweep<float, 1>(
      kind, (const float*)params, (const float*)pdot, m, (const float*)x1,
      n1, (const float*)x2, n2, (const float*)v, ldv, b, seg_cols, segs,
      (float*)part, (float*)out, ldo, (cudaStream_t)stream);
}
