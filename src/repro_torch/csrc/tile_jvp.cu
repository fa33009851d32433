// B3: the tangent matvec of one natural-parameter direction
//   out = (sum_s pdot[s] dK/dp[s])(x1, x2) @ V,
// the forward-mode rule of the covariance matvec (kernels/ops.matvec_jvp).
//
// Replaces matvec_tangent_pallas (repro/kernels/kernel_matvec.py) and its
// body _matvec_tangent_kernel, which takes jax.jvp of the tile inside the
// kernel.  Here each entry evaluates the closed-form gradient of k over the
// kind's natural slots (the derivatives B2 uses) and projects it on pdot in
// registers (JvpEntry, tangent_sweep.cuh); the value sweep's kernels
// contract it with V: in registers at b <= 16, on the fp64 tensor cores
// above, skipping the tiles outside k1's and k2's Wendland window, on the
// value sweep's grid of 64-row stripes x column segments with its
// fixed-order segment reduce, so every run gives the same bits.  What bounds
// it: the fp64 sincos and exp of the gradient per in-support entry.  Plain
// C interface for ctypes, as in tile_matvec.cu; the signature is B2's with
// m = 1, the float32 entry point is tile_jvp_f32.cu, and a launch takes
// up to tile_matvec_max_cols columns of V, as B1's.
#include "tangent_sweep.cuh"

// pdot: (N_PARAM_SLOTS,) and m must be 1; part: the (segs, n1, b) scratch,
// unused (may be null) when segs == 1; seg_cols a multiple of the
// 32-column tile.
extern "C" int tile_jvp_f64(int kind, const void* params, const void* pdot,
                            int m, const void* x1, int n1, const void* x2,
                            int n2, const void* v, int ldv, int b,
                            int seg_cols, int segs, void* part, void* out,
                            int ldo, void* stream) {
  return tile::launch_jvp_sweep<double>(
      kind, (const double*)params, (const double*)pdot, m,
      (const double*)x1, n1, (const double*)x2, n2, (const double*)v, ldv, b,
      seg_cols, segs, (double*)part, (double*)out, ldo,
      (cudaStream_t)stream);
}
