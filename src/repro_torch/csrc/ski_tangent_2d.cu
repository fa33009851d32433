// B11: the fused 2-D product-SKI stacked tangents
// W (dK_kron/dtheta_i) W^T V for all m_dirs directions, out (m_dirs, n, b);
// no noise (the diagonal does not depend on theta).
//
// Replaces fused_tangent_matvecs_nd (src/repro/kernels/ski_fused.py), the
// TPU kernel behind every gradient on a gappy 2-D field.  W^T and both
// forward axis stages are shared across the directions; direction i
// multiplies by its own outer-product spectrum (dlam_a (x) lam_b: the
// tangent of the axis that owns theta_i beside the other axis's base
// spectrum), then runs its own inverse stages and W.  The sandwich, its
// bound on an H100 and the design are in ski_fft_2d.cuh.  Plain C
// interface for ctypes, one signature for the two 2-D SKI kernels (B11
// ignores noise2); returns the CUDA error code (0 = launched).

#include "ski_fft_2d.cuh"

namespace {

template <typename T>
int tangent(int n, int m1, int m2, int L1, int L2, int s, const void* offs,
            const void* occ, const void* wcell, const void* cell,
            const void* lam1, const void* lam2, int m_dirs, double noise2,
            const void* v, int c, void* out, void* scratch0, void* scratch1,
            void* stream) {
  return static_cast<int>(ski::sandwich_2d<T>(
      n, m1, m2, L1, L2, s, static_cast<const int*>(offs),
      static_cast<const int*>(occ), static_cast<const T*>(wcell),
      static_cast<const int*>(cell), static_cast<const T*>(lam1),
      static_cast<const T*>(lam2), m_dirs, T(0), nullptr,
      static_cast<const T*>(v), c, static_cast<T*>(out),
      static_cast<T*>(scratch0), static_cast<T*>(scratch1),
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int ski_tangent_2d_f64(int n, int m1, int m2, int L1, int L2,
                                  int s, const void* offs, const void* occ,
                                  const void* wcell, const void* cell,
                                  const void* lam1, const void* lam2,
                                  int m_dirs, double noise2, const void* v,
                                  int c, void* out, void* scratch0,
                                  void* scratch1, void* stream) {
  return tangent<double>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                         lam2, m_dirs, noise2, v, c, out, scratch0, scratch1,
                         stream);
}

extern "C" int ski_tangent_2d_f32(int n, int m1, int m2, int L1, int L2,
                                  int s, const void* offs, const void* occ,
                                  const void* wcell, const void* cell,
                                  const void* lam1, const void* lam2,
                                  int m_dirs, double noise2, const void* v,
                                  int c, void* out, void* scratch0,
                                  void* scratch1, void* stream) {
  return tangent<float>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                        lam2, m_dirs, noise2, v, c, out, scratch0, scratch1,
                        stream);
}
