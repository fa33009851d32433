// B9: the m stacked tangents of a separable product kernel,
// out[i] = (sum_a (sum_s pdots[i, a, s] dk_a/dp[s]) prod_{b != a} k_b) @ V.
//
// Replaces matvec_stacked_tangent_pallas_nd (repro/kernels/
// kernel_matvec.py) and its body _matvec_stacked_tangent_kernel_nd, which
// applies the product rule through jax.linearize inside the Pallas body.
// Here the rule is written out on the value sweep's register kernel
// (ProductGradEntry, tangent_sweep.cuh): each entry evaluates every
// factor's value and closed-form natural-slot gradient once, its slot
// values dk_a/dp[s] prod_{b != a} k_b are multiply-added against V in
// registers, and the slot sums are projected on pdots once per output row.
// What bounds it on an H100: the fp64 exp (and sincos for k1/k2) of every
// factor per entry, and 2 NS b multiply-adds with V.  Plain C interface
// for ctypes: pointers and the stream are void*, each call returns
// cudaGetLastError() of its launches, nothing synchronises; kinds_code
// packs the d family ids four bits each.  The float32 entry point is
// tile_tangent_nd_f32.cu, so that nvcc builds the two types' kernels side
// by side; a call takes up to tile_matvec_max_cols columns of V.
#include "tangent_sweep.cuh"

// Rows per stripe of the kernel that d factors of kinds_code take at
// width b.
extern "C" int tile_tangent_nd_rows(int d, int kinds_code, int b) {
  return tile::product_tangent_rows(d, kinds_code, b);
}

// part: the (segs, m, n1, min(b, tile_tangent_nd_rows' columns per
// launch)) scratch, unused (may be null) when segs == 1; seg_cols a
// multiple of the 32-column tile.
extern "C" int tile_tangent_nd_f64(int d, int kinds_code, const void* params,
                                   const void* pdots, int m, const void* x1,
                                   int n1, const void* x2, int n2,
                                   const void* v, int ldv, int b,
                                   int seg_cols, int segs, void* part,
                                   void* out, int ldo, void* stream) {
  return tile::launch_product_tangent_sweep<double>(
      d, kinds_code, (const double*)params, (const double*)pdots, m,
      (const double*)x1, n1, (const double*)x2, n2, (const double*)v, ldv, b,
      seg_cols, segs, (double*)part, (double*)out, ldo,
      (cudaStream_t)stream);
}
