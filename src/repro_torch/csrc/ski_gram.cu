// B5: the fused SKI gram matvec (W K_grid W^T + noise2 I) v, v (n, b).
//
// Replaces fused_gram_matvec (src/repro/kernels/ski_fused.py), the TPU
// kernel that every CG and Lanczos iteration on near-grid data launches.
// The sandwich, its bound on an H100 and the design are in ski_fft.cuh.
// Plain C interface for ctypes, one signature for the three SKI kernels
// (B5 takes m_dirs = B = 1); returns the CUDA error code (0 = launched).

#include "ski_fft.cuh"

namespace {

template <typename T>
int gram(int n, int m, int L, int d0, int s, const void* occ,
         const void* wcell, const void* cell, const void* lams, int m_dirs,
         double noise2, const void* v, int B, int c, void* out,
         void* scratch0, void* scratch1, void* stream) {
  if (m_dirs != 1 || B != 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* vv = static_cast<const T*>(v);
  return static_cast<int>(ski::sandwich<T>(
      n, m, L, d0, s, static_cast<const int*>(occ),
      static_cast<const T*>(wcell), static_cast<const int*>(cell),
      static_cast<const T*>(lams), 1, static_cast<T>(noise2), vv, vv, 1, c,
      static_cast<T*>(out), static_cast<T*>(scratch0),
      static_cast<T*>(scratch1), static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int ski_gram_f64(int n, int m, int L, int d0, int s,
                            const void* occ, const void* wcell,
                            const void* cell, const void* lams,
                            int m_dirs, double noise2, const void* v,
                            int B, int c, void* out, void* scratch0,
                            void* scratch1, void* stream) {
  return gram<double>(n, m, L, d0, s, occ, wcell, cell, lams, m_dirs,
                      noise2, v, B, c, out, scratch0, scratch1, stream);
}

extern "C" int ski_gram_f32(int n, int m, int L, int d0, int s,
                            const void* occ, const void* wcell,
                            const void* cell, const void* lams,
                            int m_dirs, double noise2, const void* v,
                            int B, int c, void* out, void* scratch0,
                            void* scratch1, void* stream) {
  return gram<float>(n, m, L, d0, s, occ, wcell, cell, lams, m_dirs,
                     noise2, v, B, c, out, scratch0, scratch1, stream);
}
