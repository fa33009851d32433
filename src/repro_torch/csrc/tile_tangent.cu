// B2: all m stacked tangent matvecs  out[i] = (sum_s pdots[i, s] dK/dp[s]) @ V.
//
// Replaces matvec_stacked_tangent_pallas (repro/kernels/kernel_matvec.py)
// and its body _matvec_stacked_tangent_kernel.  That body linearises the
// tile with jax.linearize inside the kernel; CUDA has no such thing, so each
// entry evaluates k's closed-form gradient over the kind's <= 5 natural
// slots once.  The value sweep's register kernel accumulates the NS
// gradient slots against V, 16 columns per launch (one launch at every
// workflow call, b <= 16), and projects the slot sums on pdots as it
// writes each row, skipping the tiles outside k1's and k2's Wendland
// window (tangent_sweep.cuh).  What bounds it: the fp64 sincos and exp of
// the gradient per in-support entry.  Plain C interface for ctypes, as in
// tile_matvec.cu (a call takes up to tile_matvec_max_cols columns of V);
// the float32 entry point is tile_tangent_f32.cu, so that nvcc builds the
// two types' kernels side by side.
#include "tangent_sweep.cuh"

// Rows per stripe of the kernel that family kind takes at width b.
extern "C" int tile_tangent_rows(int kind, int b) {
  return tile::tangent_rows(kind, b);
}

// part: the (segs, m, n1, min(b, 16)) scratch, unused (may be null) when
// segs == 1; seg_cols a multiple of the 32-column tile.
extern "C" int tile_tangent_f64(int kind, const void* params,
                                const void* pdots, int m, const void* x1,
                                int n1, const void* x2, int n2, const void* v,
                                int ldv, int b, int seg_cols, int segs,
                                void* part, void* out, int ldo,
                                void* stream) {
  return tile::launch_tangent_sweep<double>(
      kind, (const double*)params, (const double*)pdots, m,
      (const double*)x1, n1, (const double*)x2, n2, (const double*)v, ldv, b,
      seg_cols, segs, (double*)part, (double*)out, ldo,
      (cudaStream_t)stream);
}
