// The 1-D SKI sandwich on line transforms held in shared memory, B5's and
// B7's gram and B6's stacked tangents:
//
//     out[dir][:, q] = W irfft(lam_{dir, q} rfft(pad_L(W^T v[:, q])))
//                      (+ noise2 v[:, q] for a gram)
//
// B5 is one member and one direction, B7 one spectrum lam_q per member q
// of v (n, B, c), B6 one member and m_dirs tangent spectra with no noise
// (the replaced TPU kernels are named in ski_gram.cu, ski_bank.cu and
// ski_tangent.cu).  Two real columns of one member ride one complex line
// (packed column col = q P + p, P = ceil(c / 2)), exact because every
// spectrum is real and even; an odd c pads a zero half per member.
//
// The transform is a four-step one, L = L1 L2 with both factors <= cap,
// the longest line one block holds (ski_lines_2d.cuh: the table and two
// buffers of a line in 227 KB, 4096 points in float64, 8192 in float32;
// cap^2 points at most, the host's plan refuses more).  It runs at every
// L, also where one line would fit a block: a packed column as one line
// keeps one block per column (5 at b = 9), and lost to its own four-step
// on the card.
//
// Position n = n1 + L1 n2, frequency k = k2 + L2 k1, w_L = e^{-2 pi i / L}:
//
//   X[k2 + L2 k1] = sum_n1 w_L1^{n1 k1} w_L^{n1 k2} sum_n2 w_L2^{n2 k2} x[n]
//
// and the inverse the same with conjugates, so a packed column's
// convolutions run as
//
//   1. columns, forward (fs_columns_fwd): one line per (col, n1 < L1).
//      W^T of the cells n1 + L1 n2 < m straight from occ, wcell and v (the
//      cells >= m are zero, m <= L / 2), the length-L2 transform over n2,
//      times w_L^{n1 k2}, into buf[col L + k2 L1 + n1];
//   2. rows (fs_rows_conv): one line per (col, k2 < L2), the L1 values at
//      buf[col L + k2 L1 ..] (contiguous).  The transform over n1, once;
//      then for each direction its spectrum lam[k2 + L2 k1], the inverse
//      over k1, times w_L^{-n1 k2}, into that direction's lines
//      (direction 0 in place: a block owns its lines);
//   3. columns, inverse (fs_columns_inv): one line per (dir, col, n1),
//      the inverse over k2, and z[n1 + L1 n2] for the cells < m only,
//      written to the addresses the line read, so the buffer ends in
//      natural cell order;
//   4. W (+ noise) (w_apply_lines_1d) on the cells, into out.
//
// Four launches whatever the directions, one scratch buffer of m_dirs x
// lines x L complex values (L1 = 1 makes step 2 a multiply by the
// spectrum).  W^T and the forward transforms run once for all directions:
// B6's directions differ only in their spectra.  Steps 1 and 3 keep lpb
// consecutive n1 lines in a block with thread = t lpb + line, so
// consecutive threads touch consecutive cells and addresses; step 2 keeps
// lpb consecutive k2 lines, each contiguous, and reads the spectrum at
// k2 + L2 k1 in a pass of its own with consecutive threads on consecutive
// k2.  With several directions step 2 holds the forward line beside the
// two buffers of the inverse, three buffers per line.  W reads consecutive
// cells, which belong to different n1 lines, so it stays a launch of its
// own.  The twiddles w_L^{+-n1 k2} come from one sincospi in double each,
// on the exact fraction n1 k2 / L.
//
// What bounds it on an H100: at the main path's shape (n ~ 7080,
// m ~ 7875, L = 16384, b = 9, float64) the gram must move ~1.5 MB
// (~0.4 us at 3.35 TB/s) and do ~1.2e7 operations (~0.3 us at 34 TFLOP/s
// fp64), B6's five directions ~4 MB and ~4e7: far below what the four
// launches cost.  It is launch-bound, and the design cuts the launches
// from the 16 of global Stockham passes (2 log4 L + 2, which B6 took
// until it moved here) to 4, and the scratch from two buffers to one.
// Every block index lives on gridDim.x.
#pragma once

#include "ski_lines_2d.cuh"

namespace ski {

// z times e^{i pi f} for f = sign 2 e / L (exact for e < L, a power of 2).
template <typename T>
__device__ __forceinline__ cplx<T> rotate(cplx<T> z, double sign, int e,
                                          int L) {
  double sn, cs;
  sincospi(sign * 2.0 * (double)e / (double)L, &sn, &cs);
  const T c = T(cs), s = T(sn);
  return cplx<T>{z.re * c - z.im * s, z.re * s + z.im * c};
}

// Step 1: W^T of the cells n1 + L1 n2 of packed column col, the transform
// over n2, times w_L^{n1 k2}, into buf[col L + k2 L1 + n1].  A block holds
// lpb consecutive n1 of one col, tpl threads each (thread = t lpb + line).
template <typename T>
__global__ void fs_columns_fwd(int n, int m, int L1, int L2, int s,
                               const int* __restrict__ offs,
                               const int* __restrict__ occ,
                               const T* __restrict__ wcell,
                               const T* __restrict__ v, int B, int c, int P,
                               int tpl, int lpb, cplx<T>* __restrict__ buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const tw = reinterpret_cast<cplx<T>*>(smem_raw);
  const int line = threadIdx.x % lpb;
  const int t = threadIdx.x / lpb;
  cplx<T>* const a = tw + L2 + (size_t)line * (L2 + 1);
  cplx<T>* const b = a + (size_t)lpb * (L2 + 1);
  const int groups = (L1 + lpb - 1) / lpb;
  const int col = blockIdx.x / groups;
  const int n1 = (blockIdx.x % groups) * lpb + line;
  const bool live = n1 < L1;
  const int q = col / P;
  const int j0 = 2 * (col % P);
  const bool two = j0 + 1 < c;
  const T* vq = v + (size_t)q * c;
  fill_twiddles(tw, L2);
  for (int n2 = t; n2 < L2; n2 += tpl) {
    const int cf = n1 + L1 * n2;
    a[n2] = (live && cf < m) ? wt_cell<T>(n, m, s, cf, offs, occ, wcell, vq,
                                          B * c, j0, two)
                             : cplx<T>{T(0), T(0)};
  }
  __syncthreads();
  const cplx<T>* x = line_transform<T, false>(a, b, tw, L2, t, tpl, nullptr);
  if (live) {
    cplx<T>* o = buf + (size_t)col * L1 * L2 + n1;
    for (int k2 = t; k2 < L2; k2 += tpl)
      o[(size_t)k2 * L1] = rotate(x[k2], -1.0, n1 * k2, L1 * L2);
  }
}

// Step 2: the L1 values of line (col, k2) at buf[col L + k2 L1 ..], the
// transform over n1; then for each of the dirs directions, times
// lam[k2 + L2 k1] (the spectrum of direction dir and member q = col / P,
// lams[dir lines / P + q]), the inverse over k1, times w_L^{-n1 k2}, into
// buf[dir lines L + col L + k2 L1 ..] (direction 0 in place).  A block
// holds lpb consecutive k2 of one col, tpl threads each (thread = line
// tpl + t: each line contiguous).  With one direction the spectrum
// multiplies the forward line in place; with more it keeps the forward
// line and writes the product to a third buffer.
template <typename T>
__global__ void fs_rows_conv(int L1, int L2, int P, int lines, int dirs,
                             const T* __restrict__ lams, int tpl, int lpb,
                             cplx<T>* __restrict__ buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const tw = reinterpret_cast<cplx<T>*>(smem_raw);
  cplx<T>* const lines0 = tw + L1;
  const size_t span = (size_t)lpb * (L1 + 1);  // one buffer of lpb lines
  const int line = threadIdx.x / tpl;
  const int t = threadIdx.x % tpl;
  cplx<T>* const a = lines0 + (size_t)line * (L1 + 1);
  cplx<T>* const b = a + span;
  const int groups = (L2 + lpb - 1) / lpb;
  const int col = blockIdx.x / groups;
  const int k20 = (blockIdx.x % groups) * lpb;
  const int k2 = k20 + line;
  const bool live = k2 < L2;
  const int L = L1 * L2;
  cplx<T>* const row = buf + (size_t)col * L + (size_t)k2 * L1;
  fill_twiddles(tw, L1);
  for (int i = t; i < L1; i += tpl)
    a[i] = live ? row[i] : cplx<T>{T(0), T(0)};
  __syncthreads();
  cplx<T>* const x = line_transform<T, false>(a, b, tw, L1, t, tpl, nullptr);
  // every line's forward result sits at the same side of its pair; the
  // product goes back there (one direction) or to the third buffer
  const size_t src = (size_t)(x - a);
  const size_t dst = dirs > 1 ? 2 * span : src;
  cplx<T>* const other = x == a ? b : a;
  for (int dir = 0; dir < dirs; ++dir) {
    const T* lam = lams + ((size_t)dir * (lines / P) + col / P) * L;
    for (int e = threadIdx.x; e < lpb * L1; e += blockDim.x) {
      const int ln = e % lpb;
      const int k1 = e / lpb;
      if (k20 + ln >= L2) continue;
      const cplx<T> z = lines0[src + (size_t)ln * (L1 + 1) + k1];
      const T l = lam[k20 + ln + (size_t)L2 * k1];
      lines0[dst + (size_t)ln * (L1 + 1) + k1] = cplx<T>{z.re * l, z.im * l};
    }
    __syncthreads();
    const cplx<T>* y = line_transform<T, true>(
        lines0 + dst + (size_t)line * (L1 + 1), other, tw, L1, t, tpl,
        nullptr);
    if (live) {
      cplx<T>* const o = row + (size_t)dir * lines * L;
      for (int n1 = t; n1 < L1; n1 += tpl)
        o[n1] = rotate(y[n1], 1.0, n1 * k2, L);
    }
    if (dir + 1 < dirs) __syncthreads();  // y's buffers are rewritten next
  }
}

// Step 3: the L2 values of line (col, n1) at buf[col L + k2 L1 + n1], the
// inverse over k2, and z[n2] to buf[col L + n1 + L1 n2] for the cells
// n1 + L1 n2 < m (the addresses the line read).  Step 1's layout, over
// every direction's lines (col < dirs lines).
template <typename T>
__global__ void fs_columns_inv(int m, int L1, int L2, int tpl, int lpb,
                               cplx<T>* __restrict__ buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const tw = reinterpret_cast<cplx<T>*>(smem_raw);
  const int line = threadIdx.x % lpb;
  const int t = threadIdx.x / lpb;
  cplx<T>* const a = tw + L2 + (size_t)line * (L2 + 1);
  cplx<T>* const b = a + (size_t)lpb * (L2 + 1);
  const int groups = (L1 + lpb - 1) / lpb;
  const int col = blockIdx.x / groups;
  const int n1 = (blockIdx.x % groups) * lpb + line;
  const bool live = n1 < L1;
  cplx<T>* const cp = buf + (size_t)col * L1 * L2 + n1;
  fill_twiddles(tw, L2);
  for (int k2 = t; k2 < L2; k2 += tpl)
    a[k2] = live ? cp[(size_t)k2 * L1] : cplx<T>{T(0), T(0)};
  __syncthreads();
  const cplx<T>* x = line_transform<T, true>(a, b, tw, L2, t, tpl, nullptr);
  if (live)
    for (int n2 = t; n2 < L2 && n1 + L1 * n2 < m; n2 += tpl)
      cp[(size_t)n2 * L1] = x[n2];
}

// Step 4: W ku (+ noise2 v) from packed column col = q P + p of ku
// (lines, L), cells in natural order, into out[i ldr + q ldq + 2p] and
// the next element; a gram's member q (ldr = B c, ldq = c: v and out
// (n, B, c)), B6's direction q (ldr = c, ldq = n c: out (m_dirs, n, c),
// v null: no noise).  The taps' loads grouped as in wt_cell.
template <typename T>
__global__ void w_apply_lines_1d(int n, int m, int L, int s,
                                 const int* __restrict__ offs,
                                 const int* __restrict__ cell,
                                 const T* __restrict__ wcell,
                                 const cplx<T>* __restrict__ ku, int lines,
                                 int P, size_t ldr, size_t ldq, int c,
                                 T noise2, const T* __restrict__ v,
                                 T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * lines) return;
  const int col = (int)(g / n);
  const int i = (int)(g % n);
  const int q = col / P;
  const int j0 = 2 * (col % P);
  const int ci = cell[i];
  const cplx<T>* kp = ku + (size_t)col * L;
  T re = T(0), im = T(0);
  for (int o0 = 0; o0 < s; o0 += kTaps) {
    cplx<T> u[kTaps];
    T wt[kTaps];
#pragma unroll
    for (int r = 0; r < kTaps; ++r) {
      const int o = o0 + r;
      const int cc = o < s ? ci + offs[o] : -1;
      const bool in = cc >= 0 && cc < m;
      wt[r] = in ? wcell[(size_t)ci * s + o] : T(0);
      u[r] = in ? kp[cc] : cplx<T>{T(0), T(0)};
    }
    // a tap outside the grid adds 0 * 0
#pragma unroll
    for (int r = 0; r < kTaps; ++r) {
      re += wt[r] * u[r].re;
      im += wt[r] * u[r].im;
    }
  }
  const size_t at = (size_t)i * ldr + (size_t)q * ldq + j0;
  const bool two = j0 + 1 < c;
  if (v != nullptr) {
    out[at] = re + noise2 * v[at];
    if (two) out[at + 1] = im + noise2 * v[at + 1];
  } else {
    out[at] = re;
    if (two) out[at + 1] = im;
  }
}

// The sandwich on v (n, B, c) on the four-step split L = L1 L2, member q
// of direction dir through lams[dir B + q] (lams (dirs B, L)): a gram
// (dirs = 1, noise_v = v: + noise2 v) into out (n, B, c), or B6's
// tangents (B = 1, noise_v null) into out (dirs, n, c).  (col_tpl,
// col_lpb) the plan of steps 1 and 3 (lines of L2), (row_tpl, row_lpb)
// that of step 2 (lines of L1, three buffers each when dirs > 1).
// scratch: dirs B ceil(c / 2) L complex values.  The host
// (kernels/ski_fused.gram_1d_plan) picks the split and plans.
template <typename T>
cudaError_t sandwich_1d(int n, int m, int L, int s, const int* offs,
                        const int* occ, const T* wcell, const int* cell,
                        const T* lams, int dirs, T noise2, const T* noise_v,
                        const T* v, int B, int c, T* out, T* scratch, int L1,
                        int col_tpl, int col_lpb, int row_tpl, int row_lpb,
                        cudaStream_t st) {
  if (n <= 0 || c <= 0 || B <= 0 || dirs <= 0) return cudaSuccess;
  if (L < 2 || (L & (L - 1)) != 0 || m <= 0 || 2 * m - 1 > L || s <= 0 ||
      L1 < 1 || (L1 & (L1 - 1)) != 0 || L1 > L ||
      (dirs > 1 && (B != 1 || noise_v != nullptr)))
    return cudaErrorInvalidValue;
  const int P = (c + 1) / 2;
  const long long lines_ll = (long long)B * P;
  const long long all_ll = lines_ll * dirs;
  const int L2 = L / L1;
  const int row_bufs = dirs > 1 ? 3 : 2;
  if (L2 < 2 || all_ll > 0x7fffffffLL || !fits_grid((long long)n * all_ll) ||
      !line_plan_ok<T>(L2, col_tpl, col_lpb) ||
      !line_plan_ok<T>(L1, row_tpl, row_lpb, row_bufs))
    return cudaErrorInvalidValue;
  const int lines = (int)lines_ll;
  const int all = (int)all_ll;
  const long long col_groups = (L1 + col_lpb - 1) / col_lpb;
  const long long fwd_blocks = lines_ll * col_groups;
  const long long inv_blocks = all_ll * col_groups;
  const long long row_blocks = lines_ll * ((L2 + row_lpb - 1) / row_lpb);
  if (inv_blocks > 0x7fffffffLL || row_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cplx<T>* const buf = reinterpret_cast<cplx<T>*>(scratch);
  const size_t col_smem = line_smem_bytes<T>(L2, col_lpb);
  const size_t row_smem = line_smem_bytes<T>(L1, row_lpb, row_bufs);
  cudaError_t err = line_smem_attr(fs_columns_fwd<T>, col_smem);
  if (err == cudaSuccess) err = line_smem_attr(fs_rows_conv<T>, row_smem);
  if (err == cudaSuccess) err = line_smem_attr(fs_columns_inv<T>, col_smem);
  if (err != cudaSuccess) return err;
  // 1. W^T and the forward transforms over n2, once for all directions
  fs_columns_fwd<T><<<(unsigned int)fwd_blocks, col_tpl * col_lpb,
                      col_smem, st>>>(n, m, L1, L2, s, offs, occ, wcell, v,
                                      B, c, P, col_tpl, col_lpb, buf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2. over n1 once, then each direction's spectrum and the inverse over k1
  fs_rows_conv<T><<<(unsigned int)row_blocks, row_tpl * row_lpb, row_smem,
                    st>>>(L1, L2, P, lines, dirs, lams, row_tpl, row_lpb,
                          buf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3. the inverse transforms over k2 of every direction, the cells < m
  fs_columns_inv<T><<<(unsigned int)inv_blocks, col_tpl * col_lpb,
                      col_smem, st>>>(m, L1, L2, col_tpl, col_lpb, buf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 4. W ku (+ noise2 v)
  const size_t ldr = dirs > 1 ? (size_t)c : (size_t)B * c;
  const size_t ldq = dirs > 1 ? (size_t)n * c : (size_t)c;
  w_apply_lines_1d<T><<<blocks_for((long long)n * all), kThreads, 0, st>>>(
      n, m, L, s, offs, cell, wcell, buf, all, P, ldr, ldq, c, noise2,
      noise_v, out);
  return cudaGetLastError();
}

}  // namespace ski
