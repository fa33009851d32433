// B8: the separable product matvec  out = (prod_a K_a)(x1, x2) @ V on
// (n, d) coordinates.
//
// Replaces matvec_pallas_nd (repro/kernels/kernel_matvec.py) and its body
// _matvec_kernel_nd.  The sweep is tile_sweep_nd_kernel in value mode (see
// tile_sweep_nd.cuh for the design, the bound on d and what bounds it on
// an H100).  Plain C interface for ctypes: pointers and the stream are
// void*, each call returns cudaGetLastError() of its launch, nothing
// synchronises.  kinds_code packs the d family ids four bits each.
#include "tile_sweep_nd.cuh"

extern "C" int tile_nd_max_cols(int m, int d, int elem_bytes) {
  return tile::sweep_nd_max_cols(m, d, (size_t)elem_bytes);
}

extern "C" int tile_matvec_nd_f64(int d, int kinds_code, const void* params,
                                  const void* x1, int n1, const void* x2,
                                  int n2, const void* v, int ldv, int b,
                                  void* out, int ldo, void* stream) {
  return tile::launch_sweep_nd<double, false>(
      d, kinds_code, (const double*)params, nullptr, 1, (const double*)x1,
      n1, (const double*)x2, n2, (const double*)v, ldv, b, (double*)out,
      ldo, (cudaStream_t)stream);
}

extern "C" int tile_matvec_nd_f32(int d, int kinds_code, const void* params,
                                  const void* x1, int n1, const void* x2,
                                  int n2, const void* v, int ldv, int b,
                                  void* out, int ldo, void* stream) {
  return tile::launch_sweep_nd<float, false>(
      d, kinds_code, (const float*)params, nullptr, 1, (const float*)x1, n1,
      (const float*)x2, n2, (const float*)v, ldv, b, (float*)out, ldo,
      (cudaStream_t)stream);
}
