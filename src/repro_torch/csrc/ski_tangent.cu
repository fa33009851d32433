// B6: the fused SKI stacked tangents W (dK_grid/dtheta_i) W^T V for all
// m_dirs directions, out (m_dirs, n, b); no noise (the diagonal does not
// depend on theta).
//
// Replaces fused_tangent_matvecs (src/repro/kernels/ski_fused.py), the TPU
// kernel behind every gradient on near-grid data.  It runs the
// shared-memory line pipeline of ski_lines_1d.cuh (the design and what
// bounds it on an H100) with the m_dirs tangent spectra: W^T and the
// forward transforms once, each direction's spectrum, inverse transforms
// and W, in 4 launches whatever m_dirs is (the global Stockham passes
// took 16 at L = 16384).  An odd b pads a zero half, so pairs never
// straddle two directions.  Plain C interface for ctypes; returns the
// CUDA error code (0 = launched).

#include "ski_lines_1d.cuh"

namespace {

template <typename T>
int tangent(int n, int m, int L, int s, const void* offs, const void* occ,
            const void* wcell, const void* cell, const void* lams,
            int m_dirs, const void* v, int c, void* out, void* scratch,
            int L1, int col_tpl, int col_lpb, int row_tpl, int row_lpb,
            void* stream) {
  return static_cast<int>(ski::sandwich_1d<T>(
      n, m, L, s, static_cast<const int*>(offs),
      static_cast<const int*>(occ), static_cast<const T*>(wcell),
      static_cast<const int*>(cell), static_cast<const T*>(lams), m_dirs,
      T(0), nullptr, static_cast<const T*>(v), 1, c, static_cast<T*>(out),
      static_cast<T*>(scratch), L1, col_tpl, col_lpb, row_tpl, row_lpb,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// scratch: m_dirs ceil(c / 2) L complex values; (L1, col_tpl, col_lpb,
// row_tpl, row_lpb) the plan of kernels/ski_fused.gram_1d_plan.
extern "C" int ski_tangent_f64(int n, int m, int L, int s, const void* offs,
                               const void* occ, const void* wcell,
                               const void* cell, const void* lams,
                               int m_dirs, const void* v, int c, void* out,
                               void* scratch, int L1, int col_tpl,
                               int col_lpb, int row_tpl, int row_lpb,
                               void* stream) {
  return tangent<double>(n, m, L, s, offs, occ, wcell, cell, lams, m_dirs, v,
                         c, out, scratch, L1, col_tpl, col_lpb, row_tpl,
                         row_lpb, stream);
}

extern "C" int ski_tangent_f32(int n, int m, int L, int s, const void* offs,
                               const void* occ, const void* wcell,
                               const void* cell, const void* lams,
                               int m_dirs, const void* v, int c, void* out,
                               void* scratch, int L1, int col_tpl,
                               int col_lpb, int row_tpl, int row_lpb,
                               void* stream) {
  return tangent<float>(n, m, L, s, offs, occ, wcell, cell, lams, m_dirs, v,
                        c, out, scratch, L1, col_tpl, col_lpb, row_tpl,
                        row_lpb, stream);
}
