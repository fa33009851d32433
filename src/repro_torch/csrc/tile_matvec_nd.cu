// B8: the separable product matvec  out = (prod_a K_a)(x1, x2) @ V on
// (n, d) coordinates, and B13, the stochastic solver's product row slab
// on a pre-gathered batch rows_x (b, d) of the points.
//
// Replaces matvec_pallas_nd and matvec_rows_pallas_nd
// (repro/kernels/kernel_matvec.py) and their body _matvec_kernel_nd.  Both
// run the value sweep of value_sweep.cuh with the product entry
// (VALUE_PRODUCT2 for d <= 2, VALUE_PRODUCT4 up to MAX_AXES): k evaluated
// and contracted in registers for b <= 16, on the fp64 tensor cores
// above; see there for the design and what bounds it on an H100.  Plain C interface for ctypes: pointers and the
// stream are void*, each call returns cudaGetLastError() of its launches,
// nothing synchronises.  kinds_code packs the d family ids four bits each.
// The float32 entry point is tile_matvec_nd_f32.cu, so that nvcc builds
// the two types' kernels side by side; the column limit per launch is
// tile_matvec_max_cols (tile_matvec.cu).
#include "value_sweep.cuh"

// part: the (segs, n1, b) scratch, unused (may be null) when segs == 1;
// seg_cols a multiple of the value sweep's 32-column tile.
extern "C" int tile_matvec_nd_f64(int d, int kinds_code, const void* params,
                                  const void* x1, int n1, const void* x2,
                                  int n2, const void* v, int ldv, int b,
                                  int seg_cols, int segs, void* part,
                                  void* out, int ldo, void* stream) {
  return tile::launch_value_product<double>(
      d, kinds_code, (const double*)params, (const double*)x1, n1,
      (const double*)x2, n2, (const double*)v, ldv, b, seg_cols, segs,
      (double*)part, (double*)out, ldo, (cudaStream_t)stream);
}
