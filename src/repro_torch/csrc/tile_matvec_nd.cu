// B8: the separable product matvec  out = (prod_a K_a)(x1, x2) @ V on
// (n, d) coordinates, and B13, the stochastic solver's product row slab
// on a pre-gathered batch rows_x (b, d) of the points.
//
// Replaces matvec_pallas_nd and matvec_rows_pallas_nd
// (repro/kernels/kernel_matvec.py) and their bodies.  The sweep is
// tile_sweep_nd_kernel in value mode on its grid of row stripes x column
// segments (see tile_sweep_nd.cuh and tile_sweep.cuh for the design, the
// bound on d, the column split and what bounds it on an H100).  Plain C
// interface for ctypes: pointers and the stream are void*, each call
// returns cudaGetLastError() of its launches, nothing synchronises.
// kinds_code packs the d family ids four bits each.
#include "tile_sweep_nd.cuh"

extern "C" int tile_nd_max_cols(int m, int d, int elem_bytes) {
  return tile::sweep_nd_max_cols(m, d, (size_t)elem_bytes);
}

// part: the (segs, n1, b) scratch, unused (may be null) when segs == 1.
extern "C" int tile_matvec_nd_f64(int d, int kinds_code, const void* params,
                                  const void* x1, int n1, const void* x2,
                                  int n2, const void* v, int ldv, int b,
                                  int seg_cols, int segs, void* part,
                                  void* out, int ldo, void* stream) {
  return tile::launch_sweep_nd<double, false>(
      d, kinds_code, (const double*)params, nullptr, 1, (const double*)x1,
      n1, (const double*)x2, n2, (const double*)v, ldv, b, seg_cols, segs,
      (double*)part, (double*)out, ldo, (cudaStream_t)stream);
}

extern "C" int tile_matvec_nd_f32(int d, int kinds_code, const void* params,
                                  const void* x1, int n1, const void* x2,
                                  int n2, const void* v, int ldv, int b,
                                  int seg_cols, int segs, void* part,
                                  void* out, int ldo, void* stream) {
  return tile::launch_sweep_nd<float, false>(
      d, kinds_code, (const float*)params, nullptr, 1, (const float*)x1, n1,
      (const float*)x2, n2, (const float*)v, ldv, b, seg_cols, segs,
      (float*)part, (float*)out, ldo, (cudaStream_t)stream);
}
