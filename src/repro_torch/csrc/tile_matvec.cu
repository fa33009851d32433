// B1: matrix-free covariance matvec  out = K(x1, x2) @ V, and B12, the
// stochastic solver's row slab  out = K(rows_x, x2) @ V  on a pre-gathered
// batch rows_x (b,) of the points.
//
// Replaces matvec_pallas and matvec_rows_pallas
// (repro/kernels/kernel_matvec.py) and their bodies.  The sweep itself is
// tile_sweep_kernel in value mode on its grid of row stripes x column
// segments (see tile_sweep.cuh for the design, why a slab splits the
// column axis and what bounds it).  Plain C interface for ctypes: pointers
// and the stream are void*, each call returns cudaGetLastError() of its
// launches, nothing synchronises.
#include "tile_sweep.cuh"

extern "C" int tile_matvec_max_cols(int elem_bytes) {
  return tile::sweep_max_cols(1, (size_t)elem_bytes);
}

// part: the (segs, n1, b) scratch, unused (may be null) when segs == 1.
extern "C" int tile_matvec_f64(int kind, const void* params, const void* x1,
                               int n1, const void* x2, int n2, const void* v,
                               int ldv, int b, int seg_cols, int segs,
                               void* part, void* out, int ldo, void* stream) {
  return tile::launch_sweep<double, false>(
      kind, (const double*)params, nullptr, 1, (const double*)x1, n1,
      (const double*)x2, n2, (const double*)v, ldv, b, seg_cols, segs,
      (double*)part, (double*)out, ldo, (cudaStream_t)stream);
}

extern "C" int tile_matvec_f32(int kind, const void* params, const void* x1,
                               int n1, const void* x2, int n2, const void* v,
                               int ldv, int b, int seg_cols, int segs,
                               void* part, void* out, int ldo, void* stream) {
  return tile::launch_sweep<float, false>(
      kind, (const float*)params, nullptr, 1, (const float*)x1, n1,
      (const float*)x2, n2, (const float*)v, ldv, b, seg_cols, segs,
      (float*)part, (float*)out, ldo, (cudaStream_t)stream);
}
