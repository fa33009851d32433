// The fused 2-D product-SKI sandwich on whole-plane passes: B11
// (ski_tangent_2d.cu) runs it, and B10 (ski_gram_2d.cu, ski_lines_2d.cuh)
// takes its W^T, W and Stockham passes for an axis longer than the
// shared-memory line cap:
//
//     out_i = W ifft2((lam1_i (x) lam2_i) * fft2(pad(W^T v))) [+ noise2 v]
//
// Replaces the TPU kernel fused_tangent_matvecs_nd (and, before B10 moved
// to ski_lines_2d.cuh, fused_gram_matvec_nd) of
// src/repro/kernels/ski_fused.py.  There one Pallas body runs W^T, the
// axis-0 FFT, a transpose held in VMEM, the axis-1 FFT, the spectrum
// multiply and the mirrored inverse stages.  Here the transpose is gone: the
// Stockham pass of ski_fft.cuh (fft_stage) takes the axis it runs along
// as an argument, and reads and writes the (L1, L2) complex plane of each
// packed column with that axis's stride, so the two axis stages need no
// data movement between them.
//
// What it computes, for a 2-D near-grid geometry (every data row in a
// distinct cell of the m1 x m2 inducing grid, flat row-major cells
// c = r1 m2 + r2; occ: cell -> row, n marks an empty cell; cell: row ->
// cell; wcell (m1 m2, s): the occupant's outer-product stencil weights at
// the s = s1 s2 flat offsets offs[o] = d1 m2 + d2, an explicit list since
// they are not one consecutive run):
//   W^T v:  u[c] = sum_o wcell[c - offs_o, o] v[occ[c - offs_o]], zero
//           where c - offs_o leaves [0, m1 m2) or the cell is empty; a flat
//           shift never wraps an occupied stencil across a row, because the
//           host accepts a geometry only when every stencil stays inside
//           both axes' ranges;
//   pack:   two real columns ride one complex column; the (m1, m2) cells
//           sit in an (L1, L2) plane of zeros, L_a a power of two
//           >= 2 m_a - 1;
//   fft2, multiply by the outer product of the two real axis spectra
//   (1/L1 and 1/L2 folded in), inverse fft2;
//   W ku:   out[i] = sum_o wcell[cell_i, o] ku[cell_i + offs_o] (+ noise2 v).
// B11 shares W^T and both forward axis stages across its m_dirs
// directions; the first inverse pass reads each forward column once per
// direction and multiplies by that direction's own pair (lam1_i, lam2_i)
// (the tangent of one axis beside the base spectrum of the other).
//
// Every kernel here puts its whole index space on gridDim.x (64-bit
// thread index), so no count of columns meets the 65,535 limit of
// gridDim.y: a predict-variance chunk of 256 columns at L1 = 512,
// L2 = 256 is 128 packed planes of 131072 points.
//
// What bounds it on an H100: at B11's shape (n ~ 6960 in a 134 x 70 grid,
// L1 x L2 = 512 x 256, b = 9, m_dirs = 2, float64) the function must move
// ~1.2 MB and do ~4e7 operations: far below what one launch costs.  This
// design transforms the whole 512 x 256 plane (~1e8 operations per packed
// column) and is bound by launches and by the traffic of its passes: W^T +
// log4 L2 + log4 L1 Stockham passes forward and back + W (20 launches at
// 512 x 256), every pass reading and writing the (P, L1, L2) complex
// ping-pong buffer (2 MB per packed column).  What the design does about
// it: radix-4 passes; strided passes read and write whole rows of the
// plane (consecutive threads on consecutive addresses along the other
// axis); twiddles from sincospi on exact power-of-two fractions.  B10's
// line kernels (ski_lines_2d.cuh) are the next step for B11 too.

#pragma once

#include "ski_fft.cuh"

namespace ski {

// W^T v into packed planes: buf[(p L1 + r1) L2 + r2] holds real columns
// 2p and 2p + 1 of u at cell (r1, r2), zero outside the m1 x m2 cells.
template <typename T>
__global__ void wt_pack_2d(int n, int m1, int m2, int L1, int L2, int s,
                           const int* __restrict__ offs,
                           const int* __restrict__ occ,
                           const T* __restrict__ wcell,
                           const T* __restrict__ v, int c, int P,
                           cplx<T>* __restrict__ buf) {
  const long long plane = (long long)L1 * L2;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= plane * P) return;
  const int col = (int)(g / plane);
  const int w = (int)(g % plane);
  const int r1 = w / L2;
  const int r2 = w % L2;
  const int j0 = 2 * col;
  const bool two = j0 + 1 < c;
  T re = T(0), im = T(0);
  if (r1 < m1 && r2 < m2) {
    const int m = m1 * m2;
    const int cf = r1 * m2 + r2;
    for (int o = 0; o < s; ++o) {
      const int cc = cf - offs[o];
      if (cc < 0 || cc >= m) continue;
      const int row = occ[cc];
      if (row >= n) continue;  // empty cell: the sentinel, never read
      const T wt = wcell[(size_t)cc * s + o];
      const T* vr = v + (size_t)row * c + j0;
      re += wt * vr[0];
      if (two) im += wt * vr[1];
    }
  }
  buf[g] = cplx<T>{re, im};
}

// W ku (+ noise2 v) from packed plane col = dir P + p into out[dir, i, 2p]
// and out[dir, i, 2p + 1] (out is (m_dirs, n, c)); v null adds no noise.
template <typename T>
__global__ void w_apply_2d(int n, int m1, int m2, int L2, int s,
                           const int* __restrict__ offs,
                           const int* __restrict__ cell,
                           const T* __restrict__ wcell,
                           const cplx<T>* __restrict__ buf, long long plane,
                           int P, int cols, T noise2,
                           const T* __restrict__ v, int c,
                           T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * cols) return;
  const int col = (int)(g / n);
  const int i = (int)(g % n);
  const int dir = col / P;
  const int j0 = 2 * (col % P);
  const int m = m1 * m2;
  const int ci = cell[i];
  const cplx<T>* ku = buf + (size_t)col * plane;
  T re = T(0), im = T(0);
  for (int o = 0; o < s; ++o) {
    const int cc = ci + offs[o];
    if (cc < 0 || cc >= m) continue;
    const T wt = wcell[(size_t)ci * s + o];
    const cplx<T> u = ku[(size_t)(cc / m2) * L2 + cc % m2];
    re += wt * u.re;
    im += wt * u.im;
  }
  const size_t at = (size_t)i * c + j0;
  T* orow = out + (size_t)dir * n * c + at;
  const bool two = j0 + 1 < c;
  if (v != nullptr) {
    orow[0] = re + noise2 * v[at];
    if (two) orow[1] = im + noise2 * v[at + 1];
  } else {
    orow[0] = re;
    if (two) orow[1] = im;
  }
}

// The whole 2-D sandwich on v (n, c): out (m_dirs, n, c), direction dir
// multiplied by lam1[dir] (x) lam2[dir] (lam1 (m_dirs, L1), lam2
// (m_dirs, L2)).  B10 is m_dirs = 1; B11 m_dirs tangent pairs.  noise_v is
// v for a gram (adds noise2 v) and null for the tangents.  scratch0/1: two
// buffers of m_dirs * ceil(c/2) * L1 * L2 complex values.  L1 and L2 are
// powers of two >= 2.
template <typename T>
cudaError_t sandwich_2d(int n, int m1, int m2, int L1, int L2, int s,
                        const int* offs, const int* occ, const T* wcell,
                        const int* cell, const T* lam1, const T* lam2,
                        int m_dirs, T noise2, const T* noise_v, const T* v,
                        int c, T* out, T* scratch0, T* scratch1,
                        cudaStream_t st) {
  if (n <= 0 || c <= 0 || m_dirs <= 0) return cudaSuccess;
  if (L1 < 2 || (L1 & (L1 - 1)) != 0 || L2 < 2 || (L2 & (L2 - 1)) != 0 ||
      m1 <= 0 || m2 <= 0 || 2 * m1 - 1 > L1 || 2 * m2 - 1 > L2 || s <= 0)
    return cudaErrorInvalidValue;
  const int P = (c + 1) / 2;
  const long long plane = (long long)L1 * L2;
  const long long cols_ll = (long long)m_dirs * P;
  if (!fits_grid(plane * cols_ll) || !fits_grid((long long)n * cols_ll))
    return cudaErrorInvalidValue;
  const int cols = (int)cols_ll;
  cplx<T>* bufs[2] = {reinterpret_cast<cplx<T>*>(scratch0),
                      reinterpret_cast<cplx<T>*>(scratch1)};
  wt_pack_2d<T><<<blocks_for(plane * P), kThreads, 0, st>>>(
      n, m1, m2, L1, L2, s, offs, occ, wcell, v, c, P, bufs[0]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int cur = 0;
  // forward: axis 1 then axis 0 on the P packed planes
  err = axis_passes<T, false>(bufs, &cur, L1, L2, 1, P, P, P, nullptr,
                              nullptr, st);
  if (err != cudaSuccess) return err;
  err = axis_passes<T, false>(bufs, &cur, L1, L2, 0, P, P, P, nullptr,
                              nullptr, st);
  if (err != cudaSuccess) return err;
  // inverse: axis 0 (its first pass multiplies and spreads the P planes
  // to m_dirs P), then axis 1
  err = axis_passes<T, true>(bufs, &cur, L1, L2, 0, cols, P, P, lam1, lam2,
                             st);
  if (err != cudaSuccess) return err;
  err = axis_passes<T, true>(bufs, &cur, L1, L2, 1, cols, cols, P, nullptr,
                             nullptr, st);
  if (err != cudaSuccess) return err;
  w_apply_2d<T><<<blocks_for((long long)n * cols), kThreads, 0, st>>>(
      n, m1, m2, L2, s, offs, cell, wcell, bufs[cur], plane, P, cols,
      noise2, noise_v, c, out);
  return cudaGetLastError();
}

}  // namespace ski
