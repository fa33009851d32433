// B9 in float32 (see tile_tangent_nd.cu), in a source of its own so that
// nvcc builds it beside the float64 kernels.
#include "tangent_sweep.cuh"

extern "C" int tile_tangent_nd_f32(int d, int kinds_code, const void* params,
                                   const void* pdots, int m, const void* x1,
                                   int n1, const void* x2, int n2,
                                   const void* v, int ldv, int b,
                                   int seg_cols, int segs, void* part,
                                   void* out, int ldo, void* stream) {
  return tile::launch_product_tangent_sweep<float>(
      d, kinds_code, (const float*)params, (const float*)pdots, m,
      (const float*)x1, n1, (const float*)x2, n2, (const float*)v, ldv, b,
      seg_cols, segs, (float*)part, (float*)out, ldo, (cudaStream_t)stream);
}
