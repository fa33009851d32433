// B7: the fused SKI bank gram matvec over B members that share one
// geometry, out[:, q, :] = (W K_q W^T + noise2 I) V[:, q, :] for V and out
// (n, B, c), member q's grid covariance given by its own spectrum lams[q]
// (lams (B, L)).
//
// Replaces fused_bank_matvec (src/repro/kernels/ski_fused.py), the TPU
// kernel that every CG and Lanczos iteration of the batched candidate
// bank launches on near-grid data.  The TPU kernel packs the B c member
// columns jointly and lets a pair straddle two members (its Hermitian
// s/d half-spectra); here pairs stay within one member, so an odd c pads
// a zero half per member, and the function is the same.  V is read and
// out written in the (n, B, c) layout directly (row stride B c, member
// offset q c): no transposes.  It runs the shared-memory line pipeline of
// ski_lines_1d.cuh (the design and what bounds it on an H100; the bound
// is bytes: V, out, B half-spectra, the stencil): the four-step split,
// 4 launches, where the global passes took 16 at L = 16384.  Plain C
// interface for ctypes, one signature with B5; returns the CUDA error
// code (0 = launched).

#include "ski_lines_1d.cuh"

namespace {

template <typename T>
int bank(int n, int m, int L, int s, const void* offs, const void* occ,
         const void* wcell, const void* cell, const void* lams,
         double noise2, const void* v, int B, int c, void* out,
         void* scratch, int L1, int col_tpl, int col_lpb, int row_tpl,
         int row_lpb, void* stream) {
  const T* vv = static_cast<const T*>(v);
  return static_cast<int>(ski::sandwich_1d<T>(
      n, m, L, s, static_cast<const int*>(offs),
      static_cast<const int*>(occ), static_cast<const T*>(wcell),
      static_cast<const int*>(cell), static_cast<const T*>(lams), 1,
      static_cast<T>(noise2), vv, vv, B, c,
      static_cast<T*>(out), static_cast<T*>(scratch), L1, col_tpl, col_lpb,
      row_tpl, row_lpb, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int ski_bank_f64(int n, int m, int L, int s, const void* offs,
                            const void* occ, const void* wcell,
                            const void* cell, const void* lams,
                            double noise2, const void* v, int B, int c,
                            void* out, void* scratch, int L1, int col_tpl,
                            int col_lpb, int row_tpl, int row_lpb,
                            void* stream) {
  return bank<double>(n, m, L, s, offs, occ, wcell, cell, lams, noise2, v, B,
                      c, out, scratch, L1, col_tpl, col_lpb, row_tpl,
                      row_lpb, stream);
}

extern "C" int ski_bank_f32(int n, int m, int L, int s, const void* offs,
                            const void* occ, const void* wcell,
                            const void* cell, const void* lams,
                            double noise2, const void* v, int B, int c,
                            void* out, void* scratch, int L1, int col_tpl,
                            int col_lpb, int row_tpl, int row_lpb,
                            void* stream) {
  return bank<float>(n, m, L, s, offs, occ, wcell, cell, lams, noise2, v, B,
                     c, out, scratch, L1, col_tpl, col_lpb, row_tpl, row_lpb,
                     stream);
}
