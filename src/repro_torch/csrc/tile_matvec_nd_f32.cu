// B8 and B13 in float32: the value sweep of value_sweep.cuh with the
// product entry (see tile_matvec_nd.cu), in a source of its own so that
// nvcc builds it beside the float64 kernels.  The contraction keeps full
// fp32 FMAs (no TF32).
#include "value_sweep.cuh"

extern "C" int tile_matvec_nd_f32(int d, int kinds_code, const void* params,
                                  const void* x1, int n1, const void* x2,
                                  int n2, const void* v, int ldv, int b,
                                  int seg_cols, int segs, void* part,
                                  void* out, int ldo, void* stream) {
  return tile::launch_value_product<float>(
      d, kinds_code, (const float*)params, (const float*)x1, n1,
      (const float*)x2, n2, (const float*)v, ldv, b, seg_cols, segs,
      (float*)part, (float*)out, ldo, (cudaStream_t)stream);
}
