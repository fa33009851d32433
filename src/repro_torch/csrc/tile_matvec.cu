// B1: matrix-free covariance matvec  out = K(x1, x2) @ V, and B12, the
// stochastic solver's row slab  out = K(rows_x, x2) @ V  on a pre-gathered
// batch rows_x (b,) of the points.
//
// Replaces matvec_pallas and matvec_rows_pallas
// (repro/kernels/kernel_matvec.py) and their body _matvec_kernel.  Both
// run the value sweep of value_sweep.cuh on its grid of 64-row stripes x
// column segments.  What bounds each regime there: the fp64 evaluation of
// k at b <= 16 (evaluated and contracted in registers, never stored), the
// contraction at b > 16 (fp64 tensor cores, mma.sync m8n8k4); k1 and k2
// skip every 64 x 32 tile outside the Wendland window |dt| < T0, which is
// exact except where V holds an inf or a nan (see value_sweep.cuh).
// Plain C interface for ctypes: pointers and the stream are void*, each
// call returns cudaGetLastError() of its launches, nothing synchronises.
// The float32 entry point is tile_matvec_f32.cu, so that nvcc builds the
// two types' kernels side by side.
#include "value_sweep.cuh"

extern "C" int tile_matvec_max_cols(int elem_bytes) {
  (void)elem_bytes;  // the value sweep's shared memory does not grow with b
  return tile::VALUE_MAX_COLS;
}

// part: the (segs, n1, b) scratch, unused (may be null) when segs == 1;
// seg_cols a multiple of the value sweep's 32-column tile.
extern "C" int tile_matvec_f64(int kind, const void* params, const void* x1,
                               int n1, const void* x2, int n2, const void* v,
                               int ldv, int b, int seg_cols, int segs,
                               void* part, void* out, int ldo, void* stream) {
  return tile::launch_value_sweep<double>(
      kind, (const double*)params, (const double*)x1, n1, (const double*)x2,
      n2, (const double*)v, ldv, b, seg_cols, segs, (double*)part,
      (double*)out, ldo, (cudaStream_t)stream);
}
