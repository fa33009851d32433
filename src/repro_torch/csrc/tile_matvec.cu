// B1: matrix-free covariance matvec  out = K(x1, x2) @ V.
//
// Replaces matvec_pallas (repro/kernels/kernel_matvec.py) and its body
// _matvec_kernel.  The sweep itself is tile_sweep_kernel in value mode (see
// tile_sweep.cuh for the design and what bounds it).  Plain C interface for
// ctypes: pointers and the stream are void*, each call returns
// cudaGetLastError() of its launch, nothing synchronises.
#include "tile_sweep.cuh"

extern "C" int tile_matvec_max_cols(int elem_bytes) {
  return tile::sweep_max_cols(1, (size_t)elem_bytes);
}

extern "C" int tile_matvec_f64(int kind, const void* params, const void* x1,
                               int n1, const void* x2, int n2, const void* v,
                               int ldv, int b, void* out, int ldo,
                               void* stream) {
  return tile::launch_sweep<double, false>(
      kind, (const double*)params, nullptr, 1, (const double*)x1, n1,
      (const double*)x2, n2, (const double*)v, ldv, b, (double*)out, ldo,
      (cudaStream_t)stream);
}

extern "C" int tile_matvec_f32(int kind, const void* params, const void* x1,
                               int n1, const void* x2, int n2, const void* v,
                               int ldv, int b, void* out, int ldo,
                               void* stream) {
  return tile::launch_sweep<float, false>(
      kind, (const float*)params, nullptr, 1, (const float*)x1, n1,
      (const float*)x2, n2, (const float*)v, ldv, b, (float*)out, ldo,
      (cudaStream_t)stream);
}
