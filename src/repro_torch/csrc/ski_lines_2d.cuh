// The 2-D product-SKI sandwiches on line transforms held in shared memory,
// B10's gram (ski_gram_2d.cu) and B11's stacked tangents
// (ski_tangent_2d.cu):
//
//     out[dir] = W C_dir (W^T v) (+ noise2 v for the gram),
//     C_dir = C1_dir (x) C2_dir,
//
// C_a the circulant embedding of axis a's Toeplitz factor (spectrum lam_a,
// 1/L_a folded in): B10 one direction, the covariance's; B11 one per
// tangent direction, the tangent of the axis that owns theta_i beside the
// other axis's base spectrum.  The replaced TPU kernels are named in
// ski_gram_2d.cu and ski_tangent_2d.cu.
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
//   pack:   two real columns ride one complex line (P = ceil(b / 2) packed
//           columns, exact because C1 and C2 are real);
//   W ku:   out[i] = sum_o wcell[cell_i, o] ku[cell_i + offs_o].
//
// The spectrum is an outer product, so the 2-D circulant is C1 (x) C2 and,
// on the m1 x m2 cells, crop(C pad(U)) = crop(C1 pad(crop(C2 pad(U)))): an
// axis-1 convolution of each occupied row, then an axis-0 convolution of
// each column.  No line outside the m1 x m2 cells is ever transformed or
// stored:
//
//   1. rows (rows_conv_2d): one line per (packed column p, row r1 < m1).
//      The block gathers W^T of the row into a shared line of L2 complex
//      values (zero past m2) and runs the forward Stockham transform once;
//      then for each direction the multiply by its lam2 (folded into the
//      first inverse pass) and the inverse, all in shared memory, and
//      writes the first m2 outputs to the compact (dirs, P, m1, m2)
//      scratch.  With several directions the forward line stays in its
//      buffer and each inverse ping-pongs between the two others;
//   2. columns (cols_conv_2d): one line per (plane, column r2 < m2) over
//      the dirs P planes, the same on the m1 values of the column
//      zero-padded to L1 with the plane's direction's lam1, the first m1
//      outputs written back in place;
//   3. W (+ noise) (w_apply_lines_2d) on the compact cells, into out
//      (dirs, n, b).
//
// Three launches per call at any b and any number of directions, one
// scratch buffer of dirs P m1 m2 complex values.  Every block index lives
// on gridDim.x.
//
// A line longer than the shared-memory cap (the table and two buffers of
// one line must fit a block's 227 KB: L <= 4096 in float64, 8192 in
// float32) makes B10 take the global-memory Stockham passes of ski_fft.cuh
// for that axis: rows by wt_pack_2d and axis_passes on the (m1, L2)
// planes, columns by pad_rows_2d and axis_passes on the (L1, m2) planes.
// B11 runs B10's gram once per direction, without the noise, there and
// where a row line of its three buffers does not fit a block (L2 > 2048 in
// float64, 4096 in float32).  The host (kernels/ski_fused.gram_2d_plan,
// given the directions for B11) picks the branch of each axis from the cap
// it passes, the threads per line (tpl) and lines per block (lpb) of each
// stage, and the scratch: see there for the sizes.
//
// What bounds it on an H100: at the main path's shape (n ~ 6960 in a
// 134 x 70 grid, L1 x L2 = 512 x 256, b = 9, float64) the gram must move
// ~1.9 MB and do ~2.3e7 operations, B11's two directions ~2.4 MB and
// ~3.5e7 (chip_smoke.ski_bound_2d): ~1 us, far below what three launches
// cost.  The design is launch-bound at
// b <= 16, and at b = 256 (~128 packed lines per row or column) bound by
// the transforms' shared-memory traffic.
//
// Shared layout of a line kernel, in complex values: the twiddles
// e^{-2 pi i j / L}, j < L (one sincospi each, once per block, on exact
// power-of-two fractions) | lpb lines of L + 1 | lpb lines of L + 1 (the
// ping-pong buffers; the + 1 keeps consecutive lines of a column group off
// one bank) [| lpb lines of L + 1: B11's rows, the forward lines].
#pragma once

#include "ski_fft.cuh"

namespace ski {

constexpr int kLineSmemLimit = 232448;  // opt-in shared memory per block
constexpr int kLineThreadsMax = 1024;

// bufs: line buffers of L + 1 per line, the two of the Stockham
// ping-pong (three where B6's and B11's rows keep the forward line beside
// them).
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
// The passes ping-pong between a and b; a non-null src is read by the
// first pass in place of a (and never written), so a line transformed
// once can feed several inverses.
template <typename T, bool INV>
__device__ cplx<T>* line_transform(cplx<T>* a, cplx<T>* b,
                                   const cplx<T>* tw, int L, int t, int tpl,
                                   const T* __restrict__ lam,
                                   const cplx<T>* src = nullptr) {
  const int lg = log2_of(L);
  for (int Ns = 1; Ns < L;) {
    const bool two = Ns == 1 && (lg & 1);
    const T* l = Ns == 1 ? lam : nullptr;
    const cplx<T>* in = (Ns == 1 && src != nullptr) ? src : a;
    if (two)
      line_pass<T, 2, INV>(in, b, tw, L, Ns, t, tpl, l);
    else
      line_pass<T, 4, INV>(in, b, tw, L, Ns, t, tpl, l);
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
// order of wt_pack_2d.
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
// p, cropped to m2, for each of the dirs directions (lam2 (dirs, L2)):
// out[((dir P + p) m1 + r1) m2 + r2].  A block holds lpb rows of one
// packed column, tpl threads each (thread = line tpl + t).  One direction
// convolves in the two ping-pong buffers; with more, the forward line
// stays in its buffer and each direction's inverse reads it in its first
// pass and ping-pongs between the other two (three buffers a line).
template <typename T>
__global__ void rows_conv_2d(int n, int m1, int m2, int L2, int s,
                             const int* __restrict__ offs,
                             const int* __restrict__ occ,
                             const T* __restrict__ wcell,
                             const T* __restrict__ v, int c,
                             const T* __restrict__ lam2, int dirs, int tpl,
                             int lpb, cplx<T>* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const tw = reinterpret_cast<cplx<T>*>(smem_raw);
  const int line = threadIdx.x / tpl;
  const int t = threadIdx.x % tpl;
  const size_t span = (size_t)lpb * (L2 + 1);  // one buffer of lpb lines
  cplx<T>* const a = tw + L2 + (size_t)line * (L2 + 1);
  cplx<T>* const b = a + span;
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
  cplx<T>* const o = out + ((size_t)p * m1 + r1) * m2;
  if (dirs == 1) {
    const cplx<T>* x = line_conv<T>(a, b, tw, L2, t, tpl, lam2);
    if (r1 < m1)
      for (int r2 = t; r2 < m2; r2 += tpl) o[r2] = x[r2];
    return;
  }
  const cplx<T>* const x =
      line_transform<T, false>(a, b, tw, L2, t, tpl, nullptr);
  cplx<T>* const other = x == a ? b : a;
  const size_t plane_dir = (size_t)((c + 1) / 2) * m;  // P m1 m2
  for (int dir = 0; dir < dirs; ++dir) {
    const cplx<T>* y = line_transform<T, true>(
        a + 2 * span, other, tw, L2, t, tpl, lam2 + (size_t)dir * L2, x);
    if (r1 < m1) {
      cplx<T>* const od = o + (size_t)dir * plane_dir;
      for (int r2 = t; r2 < m2; r2 += tpl) od[r2] = y[r2];
    }
    if (dir + 1 < dirs) __syncthreads();  // y's buffers are rewritten next
  }
}

// Stage 2: the axis-0 convolution of column r2 < m2 of plane p of buf
// ((planes, m1, ld) complex, row stride ld) by the lam1 of its direction
// (lam1 (dirs, L1), dir = p / P), cropped to m1 and written back in place.
// A block holds lpb adjacent columns, tpl threads each; thread = t lpb +
// line, so consecutive threads load consecutive columns of a row.
template <typename T>
__global__ void cols_conv_2d(int m1, int m2, int L1, int ld,
                             const T* __restrict__ lam1, int P, int tpl,
                             int lpb, cplx<T>* __restrict__ buf) {
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
  const cplx<T>* x =
      line_conv<T>(a, b, tw, L1, t, tpl, lam1 + (size_t)(p / P) * L1);
  if (r2 < m2)
    for (int r1 = t; r1 < m1; r1 += tpl) col[(size_t)r1 * ld] = x[r1];
}

// W^T v into packed planes for the rows' global branch: buf[(p m1 + r1)
// L2 + r2] holds real columns 2p and 2p + 1 of u at cell (r1, r2), zero
// for r2 >= m2.
template <typename T>
__global__ void wt_pack_2d(int n, int m1, int m2, int L2, int s,
                           const int* __restrict__ offs,
                           const int* __restrict__ occ,
                           const T* __restrict__ wcell,
                           const T* __restrict__ v, int c, int P,
                           cplx<T>* __restrict__ buf) {
  const long long plane = (long long)m1 * L2;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= plane * P) return;
  const int col = (int)(g / plane);
  const int w = (int)(g % plane);
  const int r1 = w / L2;
  const int r2 = w % L2;
  const int j0 = 2 * col;
  buf[g] = r2 < m2 ? wt_cell<T>(n, m1 * m2, s, r1 * m2 + r2, offs, occ,
                                wcell, v, c, j0, j0 + 1 < c)
                   : cplx<T>{T(0), T(0)};
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

// Stage 3: W ku (+ noise2 v) from plane col = dir P + p of ku (planes
// (m1, ldk) cells, row stride ldk, plane stride plane) into out[dir, i,
// 2p] and out[dir, i, 2p + 1] (out (dirs, n, c)); v null adds no noise
// (B11: the diagonal does not depend on theta).  The taps' loads grouped
// as in wt_cell.
template <typename T>
__global__ void w_apply_lines_2d(int n, int m1, int m2, int ldk, int s,
                                 const int* __restrict__ offs,
                                 const int* __restrict__ cell,
                                 const T* __restrict__ wcell,
                                 const cplx<T>* __restrict__ ku,
                                 long long plane, int P, int planes,
                                 T noise2, const T* __restrict__ v, int c,
                                 T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * planes) return;
  const int col = (int)(g / n);
  const int i = (int)(g % n);
  const int dir = col / P;
  const int j0 = 2 * (col % P);
  const int m = m1 * m2;
  const int ci = cell[i];
  const cplx<T>* kp = ku + (size_t)col * plane;
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
  T* const o = out + (size_t)dir * n * c + at;
  const bool two = j0 + 1 < c;
  if (v != nullptr) {
    o[0] = re + noise2 * v[at];
    if (two) o[1] = im + noise2 * v[at + 1];
  } else {
    o[0] = re;
    if (two) o[1] = im;
  }
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

// Whether the (m1, m2) cells embed in (L1, L2) planes the kernels take.
inline bool geometry_ok(int m1, int m2, int L1, int L2, int s) {
  return L1 >= 2 && (L1 & (L1 - 1)) == 0 && L2 >= 2 &&
         (L2 & (L2 - 1)) == 0 && m1 > 0 && m2 > 0 && 2 * m1 - 1 <= L1 &&
         2 * m2 - 1 <= L2 && s > 0;
}

// The gram on v (n, c) into out (n, c), + noise2 noise_v where noise_v is
// not null (B10 passes v, B11's per-direction branch null).  An axis whose
// L is <= cap takes its line kernel with (tpl, lpb) = (row_tpl, row_lpb)
// for axis 1 and (col_tpl, col_lpb) for axis 0; a longer one the global
// passes.  scratch0/1: the buffers of gram_2d_plan (scratch1 unused when
// both axes take their line kernels).
template <typename T>
cudaError_t gram_2d(int n, int m1, int m2, int L1, int L2, int s,
                    const int* offs, const int* occ, const T* wcell,
                    const int* cell, const T* lam1, const T* lam2, T noise2,
                    const T* noise_v, const T* v, int c, T* out,
                    T* scratch0, T* scratch1, int cap, int row_tpl,
                    int row_lpb, int col_tpl, int col_lpb, cudaStream_t st) {
  if (n <= 0 || c <= 0) return cudaSuccess;
  if (!geometry_ok(m1, m2, L1, L2, s)) return cudaErrorInvalidValue;
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
                            1, row_tpl, row_lpb, bufs[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ld = m2;
  } else {
    wt_pack_2d<T><<<blocks_for((long long)m1 * L2 * P), kThreads, 0, st>>>(
        n, m1, m2, L2, s, offs, occ, wcell, v, c, P, bufs[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = axis_passes<T, false>(bufs, &cur, m1, L2, 1, P, nullptr, st);
    if (err != cudaSuccess) return err;
    err = axis_passes<T, true>(bufs, &cur, m1, L2, 1, P, lam2, st);
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
                      st>>>(m1, m2, L1, ld, lam1, P, col_tpl, col_lpb,
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
    err = axis_passes<T, false>(bufs, &cur, L1, m2, 0, P, nullptr, st);
    if (err != cudaSuccess) return err;
    err = axis_passes<T, true>(bufs, &cur, L1, m2, 0, P, lam1, st);
    if (err != cudaSuccess) return err;
    ku = bufs[cur];
    plane = (long long)L1 * m2;
    ldk = m2;
  }
  // 3. W ku (+ noise2 v)
  w_apply_lines_2d<T><<<blocks_for((long long)n * P), kThreads, 0, st>>>(
      n, m1, m2, ldk, s, offs, cell, wcell, ku, plane, P, P, noise2,
      noise_v, c, out);
  return cudaGetLastError();
}

// Whether B11 runs on its three line kernels: both axes within the cap and,
// with several directions, a row line of three buffers in a block (L2 <=
// 2048 in float64, 4096 in float32); else B10's gram once per direction.
template <typename T>
inline bool tangent_on_lines(int L1, int L2, int cap, int dirs) {
  return L1 <= cap && L2 <= cap &&
         (dirs == 1 ||
          line_smem_bytes<T>(L2, 1, 3) <= (size_t)kLineSmemLimit);
}

// B11's tangents on v (n, c) into out (dirs, n, c), direction dir through
// lam1[dir] (x) lam2[dir] (lam1 (dirs, L1), lam2 (dirs, L2)), no noise.
// On the line kernels (tangent_on_lines): rows once for every direction
// with (row_tpl, row_lpb) (three buffers a line when dirs > 1), the
// columns of every direction's planes with (col_tpl, col_lpb), W;
// scratch0 holds dirs ceil(c / 2) m1 m2 complex values.  Else gram_2d per
// direction, the plan and scratch0/1 being gram_2d_plan's.  The host
// (kernels/ski_fused.gram_2d_plan with dirs) picks the same branch.
template <typename T>
cudaError_t tangent_2d(int n, int m1, int m2, int L1, int L2, int s,
                       const int* offs, const int* occ, const T* wcell,
                       const int* cell, const T* lam1, const T* lam2,
                       int dirs, const T* v, int c, T* out, T* scratch0,
                       T* scratch1, int cap, int row_tpl, int row_lpb,
                       int col_tpl, int col_lpb, cudaStream_t st) {
  if (n <= 0 || c <= 0 || dirs <= 0) return cudaSuccess;
  if (!geometry_ok(m1, m2, L1, L2, s)) return cudaErrorInvalidValue;
  if (!tangent_on_lines<T>(L1, L2, cap, dirs)) {
    for (int dir = 0; dir < dirs; ++dir) {
      const cudaError_t err = gram_2d<T>(
          n, m1, m2, L1, L2, s, offs, occ, wcell, cell,
          lam1 + (size_t)dir * L1, lam2 + (size_t)dir * L2, T(0), nullptr,
          v, c, out + (size_t)dir * n * c, scratch0, scratch1, cap, row_tpl,
          row_lpb, col_tpl, col_lpb, st);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  const int row_bufs = dirs > 1 ? 3 : 2;
  if (!line_plan_ok<T>(L2, row_tpl, row_lpb, row_bufs) ||
      !line_plan_ok<T>(L1, col_tpl, col_lpb))
    return cudaErrorInvalidValue;
  const int P = (c + 1) / 2;
  const long long planes_ll = (long long)dirs * P;
  const long long row_blocks =
      (long long)P * ((m1 + row_lpb - 1) / row_lpb);
  const long long col_blocks =
      planes_ll * ((m2 + col_lpb - 1) / col_lpb);
  if (planes_ll > 0x7fffffffLL || row_blocks > 0x7fffffffLL ||
      col_blocks > 0x7fffffffLL || !fits_grid((long long)n * planes_ll))
    return cudaErrorInvalidValue;
  const int planes = (int)planes_ll;
  cplx<T>* const buf = reinterpret_cast<cplx<T>*>(scratch0);
  const size_t row_smem = line_smem_bytes<T>(L2, row_lpb, row_bufs);
  const size_t col_smem = line_smem_bytes<T>(L1, col_lpb);
  cudaError_t err = line_smem_attr(rows_conv_2d<T>, row_smem);
  if (err == cudaSuccess) err = line_smem_attr(cols_conv_2d<T>, col_smem);
  if (err != cudaSuccess) return err;
  // 1. W^T and the forward row transforms once, each direction's inverse
  rows_conv_2d<T><<<(unsigned int)row_blocks, row_tpl * row_lpb, row_smem,
                    st>>>(n, m1, m2, L2, s, offs, occ, wcell, v, c, lam2,
                          dirs, row_tpl, row_lpb, buf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2. every direction's columns, each by its own lam1
  cols_conv_2d<T><<<(unsigned int)col_blocks, col_tpl * col_lpb, col_smem,
                    st>>>(m1, m2, L1, m2, lam1, P, col_tpl, col_lpb, buf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3. W into out (dirs, n, c)
  w_apply_lines_2d<T><<<blocks_for((long long)n * planes), kThreads, 0,
                        st>>>(n, m1, m2, m2, s, offs, cell, wcell, buf,
                              (long long)m1 * m2, P, planes, T(0), nullptr,
                              c, out);
  return cudaGetLastError();
}

}  // namespace ski
