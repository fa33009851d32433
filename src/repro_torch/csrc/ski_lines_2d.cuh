// B10's 2-D product-SKI gram on line transforms held in shared memory:
//
//     out = W C (W^T v) + noise2 v,   C = C1 (x) C2,
//
// C_a the circulant embedding of axis a's Toeplitz factor (spectrum lam_a,
// 1/L_a folded in).  The function is the one of ski_fft_2d.cuh; the order
// of work is new.  The spectrum is an outer product, so the 2-D circulant
// is C1 (x) C2 and, on the m1 x m2 cells, crop(C pad(U)) =
// crop(C1 pad(crop(C2 pad(U)))): an axis-1 convolution of each occupied
// row, then an axis-0 convolution of each column.  No line outside the
// m1 x m2 cells is ever transformed or stored:
//
//   1. rows (rows_conv_2d): one line per (packed column p, row r1 < m1).
//      The block gathers W^T of the row into a shared line of L2 complex
//      values (zero past m2), runs the forward Stockham transform, the
//      multiply by lam2 (folded into the first inverse pass) and the
//      inverse, all in shared memory, and writes the first m2 outputs to
//      the compact (P, m1, m2) scratch;
//   2. columns (cols_conv_2d): one line per (p, column r2 < m2), the same
//      on the m1 values of the column zero-padded to L1 with lam1, the
//      first m1 outputs written back in place;
//   3. W + noise (w_apply_lines_2d) on the compact cells.
//
// Three launches per call at any b, one scratch buffer of P m1 m2 complex
// values (P = ceil(b / 2): two real columns ride one complex line, exact
// because C1 and C2 are real).  Every block index lives on gridDim.x.
//
// A line longer than the shared-memory cap (the table and two buffers of
// one line must fit a block's 227 KB: L <= 4096 in float64, 8192 in
// float32) takes the global-memory Stockham passes of ski_fft.cuh for that
// axis instead: rows by wt_pack_2d and axis_passes on the (m1, L2) planes,
// columns by pad_rows_2d and axis_passes on the (L1, m2) planes.  The
// host (kernels/ski_fused.gram_2d_plan) picks the branch of each axis
// from the cap it passes, the threads per line (tpl) and lines per block
// (lpb) of each stage, and the scratch: see there for the sizes.
//
// Shared layout of a line kernel, in complex values: the twiddles
// e^{-2 pi i j / L}, j < L (one sincospi each, once per block, on exact
// power-of-two fractions) | lpb lines of L + 1 | lpb lines of L + 1 (the
// ping-pong buffers; the + 1 keeps consecutive lines of a column group off
// one bank).
#pragma once

#include "ski_fft_2d.cuh"

namespace ski {

constexpr int kLineSmemLimit = 232448;  // opt-in shared memory per block
constexpr int kLineThreadsMax = 1024;

// bufs: line buffers of L + 1 per line, the two of the Stockham
// ping-pong (three where B6's rows keep the forward line beside them).
template <typename T>
inline size_t line_smem_bytes(int L, int lines, int bufs = 2) {
  return sizeof(cplx<T>) * ((size_t)L + (size_t)bufs * lines * (L + 1));
}

// The longest power-of-two line one block holds (one line per block).
template <typename T>
inline int line_cap() {
  int L = 2;
  while (line_smem_bytes<T>(2 * L, 1) <= (size_t)kLineSmemLimit) L *= 2;
  return L;
}

template <typename T>
__device__ __forceinline__ void fill_twiddles(cplx<T>* tw, int L) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    double sn, cs;
    sincospi(-2.0 * (double)j / (double)L, &sn, &cs);
    tw[j] = cplx<T>{T(cs), T(sn)};
  }
}

// One radix-R Stockham pass of a line of length L in shared memory (src ->
// dst, the pass of fft_stage with the twiddles from the table): butterflies
// j = t, t + tpl, ... < L / R.  A non-null lam scales the loads (the
// spectrum multiply, folded into the first inverse pass).
template <typename T, int R, bool INV>
__device__ __forceinline__ void line_pass(const cplx<T>* src, cplx<T>* dst,
                                          const cplx<T>* tw, int L, int Ns,
                                          int t, int tpl,
                                          const T* __restrict__ lam) {
  const int stride = L / R;
  const int step = L / (Ns * R);
  for (int j = t; j < stride; j += tpl) {
    cplx<T> v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = src[j + r * stride];
      if (lam != nullptr) {
        const T l = lam[j + r * stride];
        v[r].re *= l;
        v[r].im *= l;
      }
    }
    const int k = j & (Ns - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) {
      // e^{-+2 pi i k r / (Ns R)} = tw[k r L / (Ns R)] (conjugated inverse)
      const cplx<T> w = tw[k * r * step];
      const T s = INV ? -w.im : w.im;
      const T re = v[r].re * w.re - v[r].im * s;
      const T im = v[r].re * s + v[r].im * w.re;
      v[r] = cplx<T>{re, im};
    }
    butterfly_core<T, R, INV>(v);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[base + r * Ns] = v[r];
  }
}

// The whole transform of a line: radix 4, one radix-2 pass first when
// log2 L is odd.  Block-wide: every thread of the block calls it with the
// same L (so the barriers match); returns the buffer holding the result.
template <typename T, bool INV>
__device__ cplx<T>* line_transform(cplx<T>* a, cplx<T>* b,
                                   const cplx<T>* tw, int L, int t, int tpl,
                                   const T* __restrict__ lam) {
  const int lg = log2_of(L);
  for (int Ns = 1; Ns < L;) {
    const bool two = Ns == 1 && (lg & 1);
    const T* l = Ns == 1 ? lam : nullptr;
    if (two)
      line_pass<T, 2, INV>(a, b, tw, L, Ns, t, tpl, l);
    else
      line_pass<T, 4, INV>(a, b, tw, L, Ns, t, tpl, l);
    __syncthreads();
    cplx<T>* tmp = a;
    a = b;
    b = tmp;
    Ns *= two ? 2 : 4;
  }
  return a;
}

// Forward transform, multiply by lam, inverse: the line's circulant
// convolution; returns the buffer holding the result.
template <typename T>
__device__ __forceinline__ cplx<T>* line_conv(cplx<T>* a, cplx<T>* b,
                                              const cplx<T>* tw, int L,
                                              int t, int tpl,
                                              const T* __restrict__ lam) {
  cplx<T>* x = line_transform<T, false>(a, b, tw, L, t, tpl, nullptr);
  return line_transform<T, true>(x, x == a ? b : a, tw, L, t, tpl, lam);
}

// The stencil taps of one cell, kTaps at a time: each group's index and
// weight loads are issued together, then its v loads, so a cell waits on
// s / kTaps round trips to memory rather than s; the sum keeps the tap
// order of wt_pack_2d and w_apply_2d.
constexpr int kTaps = 4;

// W^T at flat cell cf: sum_o wcell[cc, o] v[occ[cc], j0 (+1)], cc = cf -
// offs[o], over the taps inside the grid whose cell is occupied.
template <typename T>
__device__ __forceinline__ cplx<T> wt_cell(int n, int m, int s, int cf,
                                           const int* __restrict__ offs,
                                           const int* __restrict__ occ,
                                           const T* __restrict__ wcell,
                                           const T* __restrict__ v, int c,
                                           int j0, bool two) {
  T re = T(0), im = T(0);
  for (int o0 = 0; o0 < s; o0 += kTaps) {
    int row[kTaps];
    T wt[kTaps];
#pragma unroll
    for (int u = 0; u < kTaps; ++u) {
      const int o = o0 + u;
      const int cc = o < s ? cf - offs[o] : -1;
      const bool in = cc >= 0 && cc < m;
      row[u] = in ? occ[cc] : n;
      wt[u] = in ? wcell[(size_t)cc * s + o] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kTaps; ++u) {
      if (row[u] >= n) continue;  // empty cell: the sentinel, never read
      const T* vr = v + (size_t)row[u] * c + j0;
      re += wt[u] * vr[0];
      if (two) im += wt[u] * vr[1];
    }
  }
  return cplx<T>{re, im};
}

// Stage 1: W^T and the axis-1 convolution of row r1 < m1 of packed column
// p, cropped to m2: out[(p m1 + r1) m2 + r2].  A block holds lpb rows of
// one packed column, tpl threads each (thread = line tpl + t).
template <typename T>
__global__ void rows_conv_2d(int n, int m1, int m2, int L2, int s,
                             const int* __restrict__ offs,
                             const int* __restrict__ occ,
                             const T* __restrict__ wcell,
                             const T* __restrict__ v, int c,
                             const T* __restrict__ lam2, int tpl, int lpb,
                             cplx<T>* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const tw = reinterpret_cast<cplx<T>*>(smem_raw);
  const int line = threadIdx.x / tpl;
  const int t = threadIdx.x % tpl;
  cplx<T>* const a = tw + L2 + (size_t)line * (L2 + 1);
  cplx<T>* const b = a + (size_t)lpb * (L2 + 1);
  const int groups = (m1 + lpb - 1) / lpb;
  const int p = blockIdx.x / groups;
  const int r1 = (blockIdx.x % groups) * lpb + line;
  const int j0 = 2 * p;
  const bool two = j0 + 1 < c;
  const int m = m1 * m2;
  fill_twiddles(tw, L2);
  for (int r2 = t; r2 < L2; r2 += tpl)
    a[r2] = (r1 < m1 && r2 < m2)
                ? wt_cell<T>(n, m, s, r1 * m2 + r2, offs, occ, wcell, v, c,
                             j0, two)
                : cplx<T>{T(0), T(0)};
  __syncthreads();
  const cplx<T>* x = line_conv<T>(a, b, tw, L2, t, tpl, lam2);
  if (r1 < m1) {
    cplx<T>* o = out + ((size_t)p * m1 + r1) * m2;
    for (int r2 = t; r2 < m2; r2 += tpl) o[r2] = x[r2];
  }
}

// Stage 2: the axis-0 convolution of column r2 < m2 of packed column p of
// buf ((P, m1, ld) complex, row stride ld), cropped to m1 and written back
// in place.  A block holds lpb adjacent columns, tpl threads each; thread
// = t lpb + line, so consecutive threads load consecutive columns of a
// row.
template <typename T>
__global__ void cols_conv_2d(int m1, int m2, int L1, int ld,
                             const T* __restrict__ lam1, int tpl, int lpb,
                             cplx<T>* __restrict__ buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const tw = reinterpret_cast<cplx<T>*>(smem_raw);
  const int line = threadIdx.x % lpb;
  const int t = threadIdx.x / lpb;
  cplx<T>* const a = tw + L1 + (size_t)line * (L1 + 1);
  cplx<T>* const b = a + (size_t)lpb * (L1 + 1);
  const int groups = (m2 + lpb - 1) / lpb;
  const int p = blockIdx.x / groups;
  const int r2 = (blockIdx.x % groups) * lpb + line;
  cplx<T>* const col = buf + (size_t)p * m1 * ld + r2;
  fill_twiddles(tw, L1);
  for (int r1 = t; r1 < L1; r1 += tpl)
    a[r1] = (r1 < m1 && r2 < m2) ? col[(size_t)r1 * ld] : cplx<T>{T(0), T(0)};
  __syncthreads();
  const cplx<T>* x = line_conv<T>(a, b, tw, L1, t, tpl, lam1);
  if (r2 < m2)
    for (int r1 = t; r1 < m1; r1 += tpl) col[(size_t)r1 * ld] = x[r1];
}

// The columns' global-memory branch: dst (P, L1, m2) = the (P, m1, ld)
// cells of src, zero in rows m1 .. L1.
template <typename T>
__global__ void pad_rows_2d(int m1, int m2, int L1, int ld, int P,
                           const cplx<T>* __restrict__ src,
                           cplx<T>* __restrict__ dst) {
  const long long plane = (long long)L1 * m2;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= plane * P) return;
  const int p = (int)(g / plane);
  const int w = (int)(g % plane);
  const int r1 = w / m2;
  const int r2 = w % m2;
  dst[g] = r1 < m1 ? src[((size_t)p * m1 + r1) * ld + r2]
                   : cplx<T>{T(0), T(0)};
}

// Stage 3: W ku + noise2 v, ku the (P, m1, ldk) cells (row stride ldk,
// plane stride plane), into out[i, 2p] and out[i, 2p + 1]: w_apply_2d of
// ski_fft_2d.cuh with the taps' loads grouped as in wt_cell.
template <typename T>
__global__ void w_apply_lines_2d(int n, int m1, int m2, int ldk, int s,
                                 const int* __restrict__ offs,
                                 const int* __restrict__ cell,
                                 const T* __restrict__ wcell,
                                 const cplx<T>* __restrict__ ku,
                                 long long plane, int P, T noise2,
                                 const T* __restrict__ v, int c,
                                 T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * P) return;
  const int p = (int)(g / n);
  const int i = (int)(g % n);
  const int j0 = 2 * p;
  const int m = m1 * m2;
  const int ci = cell[i];
  const cplx<T>* kp = ku + (size_t)p * plane;
  T re = T(0), im = T(0);
  for (int o0 = 0; o0 < s; o0 += kTaps) {
    cplx<T> u[kTaps];
    T wt[kTaps];
#pragma unroll
    for (int q = 0; q < kTaps; ++q) {
      const int o = o0 + q;
      const int cc = o < s ? ci + offs[o] : -1;
      const bool in = cc >= 0 && cc < m;
      wt[q] = in ? wcell[(size_t)ci * s + o] : T(0);
      u[q] = in ? kp[(size_t)(cc / m2) * ldk + cc % m2]
                : cplx<T>{T(0), T(0)};
    }
    // a tap outside the grid adds 0 * 0
#pragma unroll
    for (int q = 0; q < kTaps; ++q) {
      re += wt[q] * u[q].re;
      im += wt[q] * u[q].im;
    }
  }
  const size_t at = (size_t)i * c + j0;
  out[at] = re + noise2 * v[at];
  if (j0 + 1 < c) out[at + 1] = im + noise2 * v[at + 1];
}

// Whether a line kernel's plan fits: tpl threads per line, lpb lines of
// bufs buffers each.
template <typename T>
inline bool line_plan_ok(int L, int tpl, int lpb, int bufs = 2) {
  return tpl >= 1 && lpb >= 1 && (long long)tpl * lpb <= kLineThreadsMax &&
         line_smem_bytes<T>(L, lpb, bufs) <= (size_t)kLineSmemLimit;
}

// Opt a line kernel in to more than the default 48 KB of dynamic shared
// memory, where its plan needs it (the cell's plans do not).
template <typename Kernel>
inline cudaError_t line_smem_attr(Kernel fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The gram on v (n, c) into out (n, c).  An axis whose L is <= cap takes
// its line kernel with (tpl, lpb) = (row_tpl, row_lpb) for axis 1 and
// (col_tpl, col_lpb) for axis 0; a longer one the global passes.
// scratch0/1: the buffers of gram_2d_plan (scratch1 unused when both axes
// take their line kernels).
template <typename T>
cudaError_t gram_2d(int n, int m1, int m2, int L1, int L2, int s,
                    const int* offs, const int* occ, const T* wcell,
                    const int* cell, const T* lam1, const T* lam2, T noise2,
                    const T* v, int c, T* out, T* scratch0, T* scratch1,
                    int cap, int row_tpl, int row_lpb, int col_tpl,
                    int col_lpb, cudaStream_t st) {
  if (n <= 0 || c <= 0) return cudaSuccess;
  if (L1 < 2 || (L1 & (L1 - 1)) != 0 || L2 < 2 || (L2 & (L2 - 1)) != 0 ||
      m1 <= 0 || m2 <= 0 || 2 * m1 - 1 > L1 || 2 * m2 - 1 > L2 || s <= 0)
    return cudaErrorInvalidValue;
  const bool rows_shared = L2 <= cap;
  const bool cols_shared = L1 <= cap;
  if ((rows_shared && !line_plan_ok<T>(L2, row_tpl, row_lpb)) ||
      (cols_shared && !line_plan_ok<T>(L1, col_tpl, col_lpb)))
    return cudaErrorInvalidValue;
  const int P = (c + 1) / 2;
  const long long row_blocks =
      (long long)P * ((m1 + row_lpb - 1) / row_lpb);
  const long long col_blocks =
      (long long)P * ((m2 + col_lpb - 1) / col_lpb);
  if (row_blocks > 0x7fffffffLL || col_blocks > 0x7fffffffLL ||
      !fits_grid((long long)m1 * L2 * P) ||
      !fits_grid((long long)L1 * m2 * P) || !fits_grid((long long)n * P))
    return cudaErrorInvalidValue;
  cplx<T>* bufs[2] = {reinterpret_cast<cplx<T>*>(scratch0),
                      reinterpret_cast<cplx<T>*>(scratch1)};
  int cur = 0;
  cudaError_t err;
  // 1. W^T and the axis-1 convolution of the m1 occupied rows
  int ld;
  if (rows_shared) {
    const size_t smem = line_smem_bytes<T>(L2, row_lpb);
    err = line_smem_attr(rows_conv_2d<T>, smem);
    if (err != cudaSuccess) return err;
    rows_conv_2d<T><<<(unsigned int)row_blocks, row_tpl * row_lpb, smem,
                      st>>>(n, m1, m2, L2, s, offs, occ, wcell, v, c, lam2,
                            row_tpl, row_lpb, bufs[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ld = m2;
  } else {
    wt_pack_2d<T><<<blocks_for((long long)m1 * L2 * P), kThreads, 0, st>>>(
        n, m1, m2, m1, L2, s, offs, occ, wcell, v, c, P, bufs[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = axis_passes<T, false>(bufs, &cur, m1, L2, 1, P, P, P, nullptr,
                                nullptr, st);
    if (err != cudaSuccess) return err;
    err = axis_passes<T, true>(bufs, &cur, m1, L2, 1, P, P, P, nullptr,
                               lam2, st);
    if (err != cudaSuccess) return err;
    ld = L2;
  }
  // 2. the axis-0 convolution of the m2 columns
  const cplx<T>* ku;
  long long plane;
  int ldk;
  if (cols_shared) {
    const size_t smem = line_smem_bytes<T>(L1, col_lpb);
    err = line_smem_attr(cols_conv_2d<T>, smem);
    if (err != cudaSuccess) return err;
    cols_conv_2d<T><<<(unsigned int)col_blocks, col_tpl * col_lpb, smem,
                      st>>>(m1, m2, L1, ld, lam1, col_tpl, col_lpb,
                            bufs[cur]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ku = bufs[cur];
    plane = (long long)m1 * ld;
    ldk = ld;
  } else {
    pad_rows_2d<T><<<blocks_for((long long)L1 * m2 * P), kThreads, 0, st>>>(
        m1, m2, L1, ld, P, bufs[cur], bufs[cur ^ 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cur ^= 1;
    err = axis_passes<T, false>(bufs, &cur, L1, m2, 0, P, P, P, nullptr,
                                nullptr, st);
    if (err != cudaSuccess) return err;
    err = axis_passes<T, true>(bufs, &cur, L1, m2, 0, P, P, P, lam1,
                               nullptr, st);
    if (err != cudaSuccess) return err;
    ku = bufs[cur];
    plane = (long long)L1 * m2;
    ldk = m2;
  }
  // 3. W ku + noise2 v
  w_apply_lines_2d<T><<<blocks_for((long long)n * P), kThreads, 0, st>>>(
      n, m1, m2, ldk, s, offs, cell, wcell, ku, plane, P, noise2, v, c, out);
  return cudaGetLastError();
}

}  // namespace ski
