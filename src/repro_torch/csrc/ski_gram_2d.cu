// B10: the fused 2-D product-SKI gram matvec (W K_kron W^T + noise2 I) v,
// v (n, b).
//
// Replaces fused_gram_matvec_nd (src/repro/kernels/ski_fused.py), the TPU
// kernel that every CG and Lanczos iteration on a gappy 2-D field
// launches.  The sandwich, its bound on an H100 and the design are in
// ski_fft_2d.cuh.  Plain C interface for ctypes, one signature for the two
// 2-D SKI kernels (B10 takes m_dirs = 1); returns the CUDA error code
// (0 = launched).

#include "ski_fft_2d.cuh"

namespace {

template <typename T>
int gram(int n, int m1, int m2, int L1, int L2, int s, const void* offs,
         const void* occ, const void* wcell, const void* cell,
         const void* lam1, const void* lam2, int m_dirs, double noise2,
         const void* v, int c, void* out, void* scratch0, void* scratch1,
         void* stream) {
  if (m_dirs != 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* vv = static_cast<const T*>(v);
  return static_cast<int>(ski::sandwich_2d<T>(
      n, m1, m2, L1, L2, s, static_cast<const int*>(offs),
      static_cast<const int*>(occ), static_cast<const T*>(wcell),
      static_cast<const int*>(cell), static_cast<const T*>(lam1),
      static_cast<const T*>(lam2), 1, static_cast<T>(noise2), vv, vv, c,
      static_cast<T*>(out), static_cast<T*>(scratch0),
      static_cast<T*>(scratch1), static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int ski_gram_2d_f64(int n, int m1, int m2, int L1, int L2, int s,
                               const void* offs, const void* occ,
                               const void* wcell, const void* cell,
                               const void* lam1, const void* lam2,
                               int m_dirs, double noise2, const void* v,
                               int c, void* out, void* scratch0,
                               void* scratch1, void* stream) {
  return gram<double>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                      lam2, m_dirs, noise2, v, c, out, scratch0, scratch1,
                      stream);
}

extern "C" int ski_gram_2d_f32(int n, int m1, int m2, int L1, int L2, int s,
                               const void* offs, const void* occ,
                               const void* wcell, const void* cell,
                               const void* lam1, const void* lam2,
                               int m_dirs, double noise2, const void* v,
                               int c, void* out, void* scratch0,
                               void* scratch1, void* stream) {
  return gram<float>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                     lam2, m_dirs, noise2, v, c, out, scratch0, scratch1,
                     stream);
}
