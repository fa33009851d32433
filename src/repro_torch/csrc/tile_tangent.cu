// B2: all m stacked tangent matvecs  out[i] = (sum_s pdots[i, s] dK/dp[s]) @ V.
//
// Replaces matvec_stacked_tangent_pallas (repro/kernels/kernel_matvec.py)
// and its body _matvec_stacked_tangent_kernel.  That body linearises the
// tile with jax.linearize inside the kernel; CUDA has no such thing, so each
// entry evaluates k and its closed-form gradient over the kind's <= 5
// natural slots once (tile_grad in tile_fns.cuh), and each direction is the
// dot product of that gradient with its pdots row.  The sweep is
// tile_sweep_kernel in tangent mode (tile_sweep.cuh).  Plain C interface for
// ctypes, as in tile_matvec.cu.
#include "tile_sweep.cuh"

extern "C" int tile_tangent_max_cols(int m, int elem_bytes) {
  return tile::sweep_max_cols(m, (size_t)elem_bytes);
}

// part: the (segs, m, n1, b) scratch, unused (may be null) when segs == 1.
extern "C" int tile_tangent_f64(int kind, const void* params,
                                const void* pdots, int m, const void* x1,
                                int n1, const void* x2, int n2, const void* v,
                                int ldv, int b, int seg_cols, int segs,
                                void* part, void* out, int ldo,
                                void* stream) {
  return tile::launch_sweep<double, true>(
      kind, (const double*)params, (const double*)pdots, m,
      (const double*)x1, n1, (const double*)x2, n2, (const double*)v, ldv, b,
      seg_cols, segs, (double*)part, (double*)out, ldo,
      (cudaStream_t)stream);
}

extern "C" int tile_tangent_f32(int kind, const void* params,
                                const void* pdots, int m, const void* x1,
                                int n1, const void* x2, int n2, const void* v,
                                int ldv, int b, int seg_cols, int segs,
                                void* part, void* out, int ldo,
                                void* stream) {
  return tile::launch_sweep<float, true>(
      kind, (const float*)params, (const float*)pdots, m, (const float*)x1,
      n1, (const float*)x2, n2, (const float*)v, ldv, b, seg_cols, segs,
      (float*)part, (float*)out, ldo, (cudaStream_t)stream);
}
