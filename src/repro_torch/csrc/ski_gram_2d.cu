// B10: the fused 2-D product-SKI gram matvec (W K_kron W^T + noise2 I) v,
// v (n, b).
//
// Replaces fused_gram_matvec_nd (src/repro/kernels/ski_fused.py), the TPU
// kernel that every CG and Lanczos iteration on a gappy 2-D field
// launches.  It runs as shared-memory line convolutions over the occupied
// lines only (ski_lines_2d.cuh: the function, the design, what bounds it
// and the long-axis branch), one direction with the noise.  Plain C
// interface for ctypes; returns the CUDA error code (0 = launched).
//
// What bounds it on an H100: at the main path's shape (n ~ 6960 in a
// 134 x 70 grid, L1 x L2 = 512 x 256, b = 9, float64) the function must
// move ~1.9 MB (~0.57 us at 3.35 TB/s) and do ~2.3e7 operations (~0.68
// us at 34 TFLOP/s fp64), far below what three launches cost: the design is
// launch-bound at b <= 16, and at b = 256 (~128 packed lines per row or
// column) bound by the transforms' shared-memory traffic.

#include "ski_lines_2d.cuh"

namespace {

template <typename T>
int gram(int n, int m1, int m2, int L1, int L2, int s, const void* offs,
         const void* occ, const void* wcell, const void* cell,
         const void* lam1, const void* lam2, double noise2, const void* v,
         int c, void* out, void* scratch0, void* scratch1, int cap,
         int row_tpl, int row_lpb, int col_tpl, int col_lpb, void* stream) {
  return static_cast<int>(ski::gram_2d<T>(
      n, m1, m2, L1, L2, s, static_cast<const int*>(offs),
      static_cast<const int*>(occ), static_cast<const T*>(wcell),
      static_cast<const int*>(cell), static_cast<const T*>(lam1),
      static_cast<const T*>(lam2), static_cast<T>(noise2),
      static_cast<const T*>(v), static_cast<const T*>(v), c,
      static_cast<T*>(out),
      static_cast<T*>(scratch0), static_cast<T*>(scratch1), cap, row_tpl,
      row_lpb, col_tpl, col_lpb, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// The longest line (a power of two) that one block holds in shared
// memory, for elements of elem_bytes (8: float64, 4: float32).
extern "C" int ski_gram_2d_line_cap(int elem_bytes) {
  return elem_bytes == 8 ? ski::line_cap<double>() : ski::line_cap<float>();
}

extern "C" int ski_gram_2d_f64(int n, int m1, int m2, int L1, int L2, int s,
                               const void* offs, const void* occ,
                               const void* wcell, const void* cell,
                               const void* lam1, const void* lam2,
                               double noise2, const void* v, int c,
                               void* out, void* scratch0, void* scratch1,
                               int cap, int row_tpl, int row_lpb,
                               int col_tpl, int col_lpb, void* stream) {
  return gram<double>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                      lam2, noise2, v, c, out, scratch0, scratch1, cap,
                      row_tpl, row_lpb, col_tpl, col_lpb, stream);
}

extern "C" int ski_gram_2d_f32(int n, int m1, int m2, int L1, int L2, int s,
                               const void* offs, const void* occ,
                               const void* wcell, const void* cell,
                               const void* lam1, const void* lam2,
                               double noise2, const void* v, int c,
                               void* out, void* scratch0, void* scratch1,
                               int cap, int row_tpl, int row_lpb,
                               int col_tpl, int col_lpb, void* stream) {
  return gram<float>(n, m1, m2, L1, L2, s, offs, occ, wcell, cell, lam1,
                     lam2, noise2, v, c, out, scratch0, scratch1, cap,
                     row_tpl, row_lpb, col_tpl, col_lpb, stream);
}
