// B11: the fused 2-D product-SKI stacked tangents
// W (dK_kron/dtheta_i) W^T V for all m_dirs directions, out (m_dirs, n, b);
// no noise (the diagonal does not depend on theta).
//
// Replaces fused_tangent_matvecs_nd (src/repro/kernels/ski_fused.py), the
// TPU kernel behind every gradient on a gappy 2-D field.  Direction i
// multiplies by its own outer-product spectrum lam1_i (x) lam2_i (the
// tangent of the axis that owns theta_i beside the other axis's base
// spectrum).  It runs B10's shared-memory line kernels (ski_lines_2d.cuh:
// the function, the design and what bounds it on an H100) with the
// directions: W^T and the forward row transforms once, each direction's
// row inverse, every direction's columns, W, in 3 launches whatever m_dirs
// and b are (the whole-plane global passes took 20 at 512 x 256), into one
// scratch of m_dirs ceil(b / 2) m1 m2 complex values.  Where an axis is
// longer than the line cap (or a row line of three buffers does not fit a
// block), B10's gram runs once per direction instead, without the noise.
// An odd b pads a zero half, so pairs never straddle two directions.
// Plain C interface for ctypes; returns the CUDA error code (0 =
// launched).

#include "ski_lines_2d.cuh"

namespace {

template <typename T>
int tangent(int n, int m1, int m2, int L1, int L2, int s, const void* offs,
            const void* occ, const void* wcell, const void* cell,
            const void* lam1, const void* lam2, int m_dirs, const void* v,
            int c, void* out, void* scratch0, void* scratch1, int cap,
            int row_tpl, int row_lpb, int col_tpl, int col_lpb,
            void* stream) {
  return static_cast<int>(ski::tangent_2d<T>(
      n, m1, m2, L1, L2, s, static_cast<const int*>(offs),
      static_cast<const int*>(occ), static_cast<const T*>(wcell),
      static_cast<const int*>(cell), static_cast<const T*>(lam1),
      static_cast<const T*>(lam2), m_dirs, static_cast<const T*>(v), c,
      static_cast<T*>(out), static_cast<T*>(scratch0),
      static_cast<T*>(scratch1), cap, row_tpl, row_lpb, col_tpl, col_lpb,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// scratch0/1 and (cap, row_tpl, row_lpb, col_tpl, col_lpb): the plan of
// kernels/ski_fused.gram_2d_plan with dirs = m_dirs.
extern "C" int ski_tangent_2d_f64(int n, int m1, int m2, int L1, int L2,
                                  int s, const void* offs, const void* occ,
                                  const void* wcell, const void* cell,
                                  const void* lam1, const void* lam2,
                                  int m_dirs, const void* v, int c,
                                  void* out, void* scratch0, void* scratch1,
                                  int cap, int row_tpl, int row_lpb,
                                  int col_tpl, int col_lpb, void* stream) {
  return tangent<double>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                         lam2, m_dirs, v, c, out, scratch0, scratch1, cap,
                         row_tpl, row_lpb, col_tpl, col_lpb, stream);
}

extern "C" int ski_tangent_2d_f32(int n, int m1, int m2, int L1, int L2,
                                  int s, const void* offs, const void* occ,
                                  const void* wcell, const void* cell,
                                  const void* lam1, const void* lam2,
                                  int m_dirs, const void* v, int c,
                                  void* out, void* scratch0, void* scratch1,
                                  int cap, int row_tpl, int row_lpb,
                                  int col_tpl, int col_lpb, void* stream) {
  return tangent<float>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                        lam2, m_dirs, v, c, out, scratch0, scratch1, cap,
                        row_tpl, row_lpb, col_tpl, col_lpb, stream);
}
