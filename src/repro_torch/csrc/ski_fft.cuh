// The fused SKI sandwich of B6 (ski_tangent.cu):
//
//     out_i = W irfft(lam_i * rfft(pad_L(W^T v))) [+ noise2 v]
//
// Replaces the TPU kernel fused_tangent_matvecs of
// src/repro/kernels/ski_fused.py, which runs W^T, the circulant-embedding
// FFT pair and W inside one Pallas body with its own FFT (the TPU has no
// FFT primitive in a kernel).  The FFT here is written by hand as well; no
// library transform runs inside the path.  B5 and B7 (fused_gram_matvec,
// fused_bank_matvec) compute the same function with a noise term on line
// transforms held in shared memory (ski_lines_1d.cuh); sandwich() still
// takes their shapes (B = m_dirs = 1, or m_dirs = 1 with B members).
//
// What it computes, for a near-grid geometry (every data row in a distinct
// cell of the m-cell inducing grid; occ: cell -> row, n marks an empty
// cell; cell: row -> cell; wcell (m, s): the occupant's stencil weights
// for the consecutive offsets d0 .. d0+s-1):
//   W^T v:  u[c] = sum_o wcell[c-d_o, o] v[occ[c-d_o]], zero where c-d_o
//           leaves [0, m) or the cell is empty;
//   pack:   two real columns ride one complex column, zero rows to L;
//   FFT, multiply by the real spectrum lam (1/L folded in), inverse FFT;
//   W ku:   out[i] = sum_o wcell[cell_i, o] ku[cell_i + d_o] (+ noise2 v).
// Pair packing is exact because both halves of a pair see the same real,
// even spectrum, so pairs are packed within one member and never straddle
// two (an odd column count pads a zero half).  B6 shares W^T and the
// forward FFT across its m_dirs tangent spectra: the first inverse stage
// reads each forward column once per direction and writes m_dirs * P
// columns.  With B members, v is (n, B, c) and the packed columns of
// member q are multiplied by that member's own spectrum.
//
// The Stockham pass (fft_stage) is the one the 2-D sandwich runs
// (ski_fft_2d.cuh): it takes the axis of an (L1, L2) plane as an
// argument, and a 1-D transform of length L is the (1, L) plane along
// axis 1.  Every kernel here puts its whole index space on gridDim.x, so
// no count of packed columns (m_dirs * B * ceil(c / 2)) meets the 65,535
// limit of gridDim.y.
//
// What bounds it on an H100: at the main path's shape (n ~ 7080,
// m ~ 7875, L = 16384, b = 9, float64) the function must move ~1.5 MB
// (~0.4 us at 3.35 TB/s) and do ~1.2e7 FFT operations (~0.3 us at
// 34 TFLOP/s fp64): far below what one launch costs.  This design is
// launch-latency bound: W^T + 2 log4(L) Stockham stages + W, one launch
// each (16 at L = 16384), every stage reading and writing the (P, L)
// complex ping-pong buffer (1.3 MB at b = 9, so it stays in the 50 MB L2).
// What the design does about it: radix-4 stages halve the passes of
// radix 2; the buffers stay in L2; twiddles come from sincospi in double
// on exact power-of-two fractions (never sin of a large argument); empty
// cells are tested by their sentinel, never read.  A one-column-per-block
// transform does not fit (one float64 column is 256 KB, a block has
// 227 KB); the four-step L = L1 L2 split with the sub-transforms in shared
// memory, which B5 and B7 run (ski_lines_1d.cuh: 4 launches), would take
// B6 as well, with its m_dirs spectra in the row step.

#pragma once

#include <cuda_runtime.h>

namespace ski {

constexpr int kThreads = 256;

template <typename T>
struct alignas(2 * sizeof(T)) cplx {
  T re, im;
};

// W^T v into packed columns.  v is (n, B, c) row-major (row stride B c,
// member offset q c); packed column col = q * P + p (P = ceil(c / 2))
// holds member q's real columns 2p and 2p+1:
// buf[col * L + cell] = u[cell, q, 2p] + i u[cell, q, 2p+1].  Pairs never
// straddle two members: an odd c leaves the last pair's half zero.
template <typename T>
__global__ void wt_pack(int n, int m, int L, int d0, int s,
                        const int* __restrict__ occ,
                        const T* __restrict__ wcell,
                        const T* __restrict__ v, int B, int c, int P,
                        int cols, cplx<T>* __restrict__ buf) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)L * cols) return;
  const int col = (int)(g / L);
  const int cl = (int)(g % L);
  const int q = col / P;
  const int j0 = 2 * (col % P);
  const bool two = j0 + 1 < c;
  const size_t row_stride = (size_t)B * c;
  T re = T(0), im = T(0);
  if (cl < m) {
    for (int o = 0; o < s; ++o) {
      const int cc = cl - d0 - o;
      if (cc < 0 || cc >= m) continue;
      const int row = occ[cc];
      if (row >= n) continue;  // empty cell: the sentinel, never read
      const T w = wcell[(size_t)cc * s + o];
      const T* vr = v + (size_t)row * row_stride + (size_t)q * c + j0;
      re += w * vr[0];
      if (two) im += w * vr[1];
    }
  }
  buf[g] = cplx<T>{re, im};
}

// The radix-R butterfly on R values that already carry their twiddles.
template <typename T, int R, bool INV>
__device__ __forceinline__ void butterfly_core(cplx<T>* v) {
  if (R == 2) {
    const cplx<T> a = v[0], b = v[1];
    v[0] = cplx<T>{a.re + b.re, a.im + b.im};
    v[1] = cplx<T>{a.re - b.re, a.im - b.im};
  } else {
    const cplx<T> a0{v[0].re + v[2].re, v[0].im + v[2].im};
    const cplx<T> a1{v[0].re - v[2].re, v[0].im - v[2].im};
    const cplx<T> a2{v[1].re + v[3].re, v[1].im + v[3].im};
    const cplx<T> d{v[1].re - v[3].re, v[1].im - v[3].im};
    // forward: -i d, inverse: +i d
    const cplx<T> a3 = INV ? cplx<T>{-d.im, d.re} : cplx<T>{d.im, -d.re};
    v[0] = cplx<T>{a0.re + a2.re, a0.im + a2.im};
    v[1] = cplx<T>{a1.re + a3.re, a1.im + a3.im};
    v[2] = cplx<T>{a0.re - a2.re, a0.im - a2.im};
    v[3] = cplx<T>{a1.re - a3.re, a1.im - a3.im};
  }
}

// The twiddles and the radix-R butterfly of one Stockham pass on the R
// values v[r] = in[j + r L / R] of sub-transform position k = j mod Ns.
template <typename T, int R, bool INV>
__device__ __forceinline__ void butterfly(cplx<T>* v, int k, int Ns) {
#pragma unroll
  for (int r = 1; r < R; ++r) {
    // e^{-+2 pi i k r / (Ns R)}: an exact power-of-two fraction of pi
    double sn, cs;
    sincospi((INV ? 2.0 : -2.0) * (double)(k * r) / (double)(Ns * R), &sn,
             &cs);
    const T c = T(cs), s = T(sn);
    const T re = v[r].re * c - v[r].im * s;
    const T im = v[r].re * s + v[r].im * c;
    v[r] = cplx<T>{re, im};
  }
  butterfly_core<T, R, INV>(v);
}

// One radix-R Stockham pass (natural order in, natural order out after
// the last pass) along `axis` of every (L1, L2) plane: each plane is
// (outer, len, inner) with (1, L1, L2) for axis 0 and (L1, L2, 1) for
// axis 1, so consecutive threads take consecutive `inner` addresses; a
// 1-D transform of length L is the plane (1, L) along axis 1.  Every
// index lives on gridDim.x (64-bit thread index), so no count of planes
// meets the 65,535 limit of gridDim.y.  Plane `col` of dst reads plane
// col % cols_src of src; a non-null lam2 scales the loads by the spectrum
// of dir = col / P: lam2[dir, r2] (1-D: each direction's or member's own
// spectrum), times lam1[dir, r1] where lam1 is non-null (2-D: the outer
// product of the axis spectra); lam1 alone scales by lam1[dir, r1] (the
// 2-D gram's axis-0 convolution, ski_lines_2d.cuh).  The multiply is
// folded into the first inverse pass.
template <typename T, int R, bool INV>
__global__ void fft_stage(const cplx<T>* __restrict__ src,
                          cplx<T>* __restrict__ dst, int L1, int L2,
                          int axis, int Ns, int cols_out, int cols_src,
                          int P, const T* __restrict__ lam1,
                          const T* __restrict__ lam2) {
  const int len = axis == 0 ? L1 : L2;
  const int inner = axis == 0 ? L2 : 1;
  const int stride = len / R;
  const long long plane = (long long)L1 * L2;
  const long long per = plane / R;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= per * cols_out) return;
  const int col = (int)(g / per);
  const long long w = g % per;
  const int i = (int)(w % inner);
  const long long t = w / inner;
  const int j = (int)(t % stride);
  const int o = (int)(t / stride);
  const cplx<T>* in = src + (size_t)(col % cols_src) * plane;
  cplx<T>* out = dst + (size_t)col * plane;
  const size_t row0 = (size_t)o * len;
  cplx<T> v[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    v[r] = in[(row0 + j + r * stride) * inner + i];
  if (lam1 != nullptr || lam2 != nullptr) {
    const int dir = col / P;
    const T* l1 = lam1 != nullptr ? lam1 + (size_t)dir * L1 : nullptr;
    const T* l2 = lam2 != nullptr ? lam2 + (size_t)dir * L2 : nullptr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pos = j + r * stride;
      T l;
      if (l2 != nullptr) {
        l = axis == 0 ? l2[i] : l2[pos];
        if (l1 != nullptr) l *= axis == 0 ? l1[pos] : l1[o];
      } else {
        l = axis == 0 ? l1[pos] : l1[o];
      }
      v[r].re *= l;
      v[r].im *= l;
    }
  }
  const int k = j & (Ns - 1);
  butterfly<T, R, INV>(v, k, Ns);
  const int base = (j - k) * R + k;
#pragma unroll
  for (int r = 0; r < R; ++r)
    out[(row0 + base + r * Ns) * inner + i] = v[r];
}

// W ku (+ noise2 v) from packed column col = (dir * B + q) * P + p into
// out[dir, i, q, 2p] and out[dir, i, q, 2p+1] (out is (m_dirs, n, B, c));
// v null adds no noise.
template <typename T>
__global__ void w_apply(int n, int m, int L, int d0, int s,
                        const int* __restrict__ cell,
                        const T* __restrict__ wcell,
                        const cplx<T>* __restrict__ buf, int P, int cols,
                        T noise2, const T* __restrict__ v, int B, int c,
                        T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * cols) return;
  const int col = (int)(g / n);
  const int i = (int)(g % n);
  const int dq = col / P;
  const int dir = dq / B;
  const int q = dq % B;
  const int j0 = 2 * (col % P);
  const int ci = cell[i];
  const cplx<T>* ku = buf + (size_t)col * L;
  T re = T(0), im = T(0);
  for (int o = 0; o < s; ++o) {
    const int cc = ci + d0 + o;
    if (cc < 0 || cc >= m) continue;
    const T w = wcell[(size_t)ci * s + o];
    re += w * ku[cc].re;
    im += w * ku[cc].im;
  }
  const size_t row_stride = (size_t)B * c;
  const size_t at = (size_t)i * row_stride + (size_t)q * c + j0;
  T* orow = out + (size_t)dir * n * row_stride + at;
  const bool two = j0 + 1 < c;
  if (v != nullptr) {
    orow[0] = re + noise2 * v[at];
    if (two) orow[1] = im + noise2 * v[at + 1];
  } else {
    orow[0] = re;
    if (two) orow[1] = im;
  }
}

inline unsigned int blocks_for(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

// Whether `threads` fit one launch of kThreads-wide blocks on gridDim.x.
inline bool fits_grid(long long threads) {
  return threads <= (long long)kThreads * 0x7fffffffLL;
}

template <typename T, bool INV>
cudaError_t launch_stage(int R, const cplx<T>* src, cplx<T>* dst, int L1,
                         int L2, int axis, int Ns, int cols_out,
                         int cols_src, int P, const T* lam1, const T* lam2,
                         cudaStream_t st) {
  const unsigned int grid = blocks_for((long long)L1 * L2 / R * cols_out);
  if (R == 2)
    fft_stage<T, 2, INV><<<grid, kThreads, 0, st>>>(
        src, dst, L1, L2, axis, Ns, cols_out, cols_src, P, lam1, lam2);
  else
    fft_stage<T, 4, INV><<<grid, kThreads, 0, st>>>(
        src, dst, L1, L2, axis, Ns, cols_out, cols_src, P, lam1, lam2);
  return cudaGetLastError();
}

__host__ __device__ inline int log2_of(int L) {
  int k = 0;
  while ((1 << k) < L) ++k;
  return k;
}

// The passes of one axis of the (L1, L2) planes: Stockham radix 4 (one
// radix-2 pass first when log2 L is odd).  first_lam1/2: the spectra of
// the first pass (lam2 null: no multiply).
template <typename T, bool INV>
cudaError_t axis_passes(cplx<T>** bufs, int* cur, int L1, int L2, int axis,
                        int cols_out, int cols_src, int P,
                        const T* first_lam1, const T* first_lam2,
                        cudaStream_t st) {
  const int L = axis == 0 ? L1 : L2;
  const int lg = log2_of(L);
  for (int Ns = 1; Ns < L;) {
    const int R = (Ns == 1 && (lg & 1)) ? 2 : 4;
    const bool first = Ns == 1;
    cudaError_t err = launch_stage<T, INV>(
        R, bufs[*cur], bufs[*cur ^ 1], L1, L2, axis, Ns, cols_out,
        first ? cols_src : cols_out, P, first ? first_lam1 : nullptr,
        first ? first_lam2 : nullptr, st);
    if (err != cudaSuccess) return err;
    *cur ^= 1;
    Ns *= R;
  }
  return cudaSuccess;
}

// The whole sandwich on v (n, B, c): out (m_dirs, n, B, c), direction
// dir of member q multiplied by the spectrum lams[dir * B + q] (lams is
// (m_dirs * B, L)).  B5 is B = m_dirs = 1; B6 is B = 1 with m_dirs
// tangent spectra; B7 is m_dirs = 1 with one spectrum per bank member.
// noise_v is v for a gram (adds noise2 v) and null for the tangents.
// scratch0/1: two buffers of m_dirs * B * ceil(c/2) * L complex values.
// L is a power of two >= 2.
template <typename T>
cudaError_t sandwich(int n, int m, int L, int d0, int s, const int* occ,
                     const T* wcell, const int* cell, const T* lams,
                     int m_dirs, T noise2, const T* noise_v, const T* v,
                     int B, int c, T* out, T* scratch0, T* scratch1,
                     cudaStream_t st) {
  const int P = (c + 1) / 2;
  if (n <= 0 || c <= 0 || B <= 0 || m_dirs <= 0) return cudaSuccess;
  const long long cols_ll = (long long)m_dirs * B * P;
  if (L < 2 || (L & (L - 1)) != 0 || cols_ll > 0x7fffffffLL ||
      !fits_grid((long long)L * cols_ll) || !fits_grid((long long)n * cols_ll))
    return cudaErrorInvalidValue;
  const int F = B * P;  // forward columns
  const int cols = (int)cols_ll;
  cplx<T>* bufs[2] = {reinterpret_cast<cplx<T>*>(scratch0),
                      reinterpret_cast<cplx<T>*>(scratch1)};
  wt_pack<T><<<blocks_for((long long)L * F), kThreads, 0, st>>>(
      n, m, L, d0, s, occ, wcell, v, B, c, P, F, bufs[0]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int cur = 0;
  // forward transform of the F packed columns
  err = axis_passes<T, false>(bufs, &cur, 1, L, 1, F, F, P, nullptr,
                              nullptr, st);
  if (err != cudaSuccess) return err;
  // inverse: the first pass multiplies by each column's spectrum and
  // spreads the F columns to m_dirs * F
  err = axis_passes<T, true>(bufs, &cur, 1, L, 1, cols, F, P, nullptr, lams,
                             st);
  if (err != cudaSuccess) return err;
  w_apply<T><<<blocks_for((long long)n * cols), kThreads, 0, st>>>(
      n, m, L, d0, s, cell, wcell, bufs[cur], P, cols, noise2, noise_v, B,
      c, out);
  return cudaGetLastError();
}

}  // namespace ski
