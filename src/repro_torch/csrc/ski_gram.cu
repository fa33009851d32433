// B5: the fused SKI gram matvec (W K_grid W^T + noise2 I) v, v (n, b).
//
// Replaces fused_gram_matvec (src/repro/kernels/ski_fused.py), the TPU
// kernel that every CG and Lanczos iteration on near-grid data launches.
// It runs the shared-memory line pipeline of ski_lines_1d.cuh (the design
// and what bounds it on an H100) with one member: the four-step split
// L = L1 L2, 4 launches.  Plain C interface for ctypes, one signature with
// B7 (B5 takes B = 1); returns the CUDA error code (0 = launched).

#include "ski_lines_1d.cuh"

namespace {

template <typename T>
int gram(int n, int m, int L, int s, const void* offs, const void* occ,
         const void* wcell, const void* cell, const void* lams,
         double noise2, const void* v, int B, int c, void* out,
         void* scratch, int L1, int col_tpl, int col_lpb, int row_tpl,
         int row_lpb, void* stream) {
  if (B != 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* vv = static_cast<const T*>(v);
  return static_cast<int>(ski::sandwich_1d<T>(
      n, m, L, s, static_cast<const int*>(offs),
      static_cast<const int*>(occ), static_cast<const T*>(wcell),
      static_cast<const int*>(cell), static_cast<const T*>(lams), 1,
      static_cast<T>(noise2), vv, vv, 1, c,
      static_cast<T*>(out), static_cast<T*>(scratch), L1, col_tpl, col_lpb,
      row_tpl, row_lpb, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int ski_gram_f64(int n, int m, int L, int s, const void* offs,
                            const void* occ, const void* wcell,
                            const void* cell, const void* lams,
                            double noise2, const void* v, int B, int c,
                            void* out, void* scratch, int L1, int col_tpl,
                            int col_lpb, int row_tpl, int row_lpb,
                            void* stream) {
  return gram<double>(n, m, L, s, offs, occ, wcell, cell, lams, noise2, v, B,
                      c, out, scratch, L1, col_tpl, col_lpb, row_tpl,
                      row_lpb, stream);
}

extern "C" int ski_gram_f32(int n, int m, int L, int s, const void* offs,
                            const void* occ, const void* wcell,
                            const void* cell, const void* lams,
                            double noise2, const void* v, int B, int c,
                            void* out, void* scratch, int L1, int col_tpl,
                            int col_lpb, int row_tpl, int row_lpb,
                            void* stream) {
  return gram<float>(n, m, L, s, offs, occ, wcell, cell, lams, noise2, v, B,
                     c, out, scratch, L1, col_tpl, col_lpb, row_tpl, row_lpb,
                     stream);
}
