// B6: the fused SKI stacked tangents W (dK_grid/dtheta_i) W^T V for all
// m_dirs directions, out (m_dirs, n, b); no noise (the diagonal does not
// depend on theta).
//
// Replaces fused_tangent_matvecs (src/repro/kernels/ski_fused.py), the TPU
// kernel behind every gradient on near-grid data.  W^T and the forward
// FFT are shared across the directions; each direction gets its own
// spectrum multiply, inverse FFT and W.  An odd b is padded with a zero
// column, so pairs never straddle two directions.  The sandwich, its
// bound on an H100 and the design are in ski_fft.cuh.  Plain C interface
// for ctypes, one signature for the three SKI kernels (B6 takes B = 1 and
// ignores noise2); returns the CUDA error code (0 = launched).

#include "ski_fft.cuh"

namespace {

template <typename T>
int tangent(int n, int m, int L, int d0, int s, const void* occ,
            const void* wcell, const void* cell, const void* lams, int m_dirs,
            double noise2, const void* v, int B, int c, void* out,
            void* scratch0, void* scratch1, void* stream) {
  if (B != 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* vv = static_cast<const T*>(v);
  return static_cast<int>(ski::sandwich<T>(
      n, m, L, d0, s, static_cast<const int*>(occ),
      static_cast<const T*>(wcell), static_cast<const int*>(cell),
      static_cast<const T*>(lams), m_dirs, T(0), nullptr, vv, 1, c,
      static_cast<T*>(out), static_cast<T*>(scratch0),
      static_cast<T*>(scratch1), static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int ski_tangent_f64(int n, int m, int L, int d0, int s,
                               const void* occ, const void* wcell,
                               const void* cell, const void* lams,
                               int m_dirs, double noise2, const void* v,
                               int B, int c, void* out, void* scratch0,
                               void* scratch1, void* stream) {
  return tangent<double>(n, m, L, d0, s, occ, wcell, cell, lams, m_dirs,
                         noise2, v, B, c, out, scratch0, scratch1, stream);
}

extern "C" int ski_tangent_f32(int n, int m, int L, int d0, int s,
                               const void* occ, const void* wcell,
                               const void* cell, const void* lams,
                               int m_dirs, double noise2, const void* v,
                               int B, int c, void* out, void* scratch0,
                               void* scratch1, void* stream) {
  return tangent<float>(n, m, L, d0, s, occ, wcell, cell, lams, m_dirs,
                        noise2, v, B, c, out, scratch0, scratch1, stream);
}
