// The global-memory Stockham passes of B10's 2-D product-SKI gram
// (ski_lines_2d.cuh) for an axis longer than its shared-memory line cap,
// and the complex type and radix-4/2 butterfly that every SKI line kernel
// (ski_lines_2d.cuh, ski_lines_1d.cuh: B5, B6, B7, B10, B11) reuses.
//
// fft_stage is one radix-R Stockham pass along an axis of every (L1, L2)
// complex plane, reading and writing the plane with that axis's stride,
// so the two axes need no transpose between them; the first inverse pass
// may multiply by that axis's spectrum as it loads.  Every kernel here
// puts its whole index space on gridDim.x, so no count of packed planes
// meets the 65,535 limit of gridDim.y.
//
// What bounds it on an H100: each pass reads and writes every plane once
// (bytes), and a transform takes log4 L of them, one launch each; the
// line kernels exist to cut both, and only a line too long for a block's
// shared memory comes here.  What the design does about it: radix-4
// passes halve the passes of radix 2; consecutive threads take
// consecutive addresses along the other axis; twiddles come from sincospi
// in double on exact power-of-two fractions (never sin of a large
// argument).

#pragma once

#include <cuda_runtime.h>

namespace ski {

constexpr int kThreads = 256;

template <typename T>
struct alignas(2 * sizeof(T)) cplx {
  T re, im;
};

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
// axis 1, so consecutive threads take consecutive `inner` addresses.
// Every index lives on gridDim.x (64-bit thread index), so no count of
// planes meets the 65,535 limit of gridDim.y.  A non-null lam scales the
// loads by the axis spectrum at the point's position along the axis (the
// spectrum multiply, folded into the first inverse pass).
template <typename T, int R, bool INV>
__global__ void fft_stage(const cplx<T>* __restrict__ src,
                          cplx<T>* __restrict__ dst, int L1, int L2,
                          int axis, int Ns, int cols,
                          const T* __restrict__ lam) {
  const int len = axis == 0 ? L1 : L2;
  const int inner = axis == 0 ? L2 : 1;
  const int stride = len / R;
  const long long plane = (long long)L1 * L2;
  const long long per = plane / R;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= per * cols) return;
  const int col = (int)(g / per);
  const long long w = g % per;
  const int i = (int)(w % inner);
  const long long t = w / inner;
  const int j = (int)(t % stride);
  const int o = (int)(t / stride);
  const cplx<T>* in = src + (size_t)col * plane;
  cplx<T>* out = dst + (size_t)col * plane;
  const size_t row0 = (size_t)o * len;
  cplx<T> v[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    v[r] = in[(row0 + j + r * stride) * inner + i];
  if (lam != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T l = lam[j + r * stride];
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

inline unsigned int blocks_for(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

// Whether `threads` fit one launch of kThreads-wide blocks on gridDim.x.
inline bool fits_grid(long long threads) {
  return threads <= (long long)kThreads * 0x7fffffffLL;
}

template <typename T, bool INV>
cudaError_t launch_stage(int R, const cplx<T>* src, cplx<T>* dst, int L1,
                         int L2, int axis, int Ns, int cols, const T* lam,
                         cudaStream_t st) {
  const unsigned int grid = blocks_for((long long)L1 * L2 / R * cols);
  if (R == 2)
    fft_stage<T, 2, INV><<<grid, kThreads, 0, st>>>(src, dst, L1, L2, axis,
                                                    Ns, cols, lam);
  else
    fft_stage<T, 4, INV><<<grid, kThreads, 0, st>>>(src, dst, L1, L2, axis,
                                                    Ns, cols, lam);
  return cudaGetLastError();
}

__host__ __device__ inline int log2_of(int L) {
  int k = 0;
  while ((1 << k) < L) ++k;
  return k;
}

// The passes of one axis of the cols (L1, L2) planes: Stockham radix 4
// (one radix-2 pass first when log2 L is odd), ping-ponging between
// bufs[*cur] and bufs[*cur ^ 1].  first_lam: the spectrum of the first
// pass (null: no multiply).
template <typename T, bool INV>
cudaError_t axis_passes(cplx<T>** bufs, int* cur, int L1, int L2, int axis,
                        int cols, const T* first_lam, cudaStream_t st) {
  const int L = axis == 0 ? L1 : L2;
  const int lg = log2_of(L);
  for (int Ns = 1; Ns < L;) {
    const int R = (Ns == 1 && (lg & 1)) ? 2 : 4;
    cudaError_t err = launch_stage<T, INV>(
        R, bufs[*cur], bufs[*cur ^ 1], L1, L2, axis, Ns, cols,
        Ns == 1 ? first_lam : nullptr, st);
    if (err != cudaSuccess) return err;
    *cur ^= 1;
    Ns *= R;
  }
  return cudaSuccess;
}

}  // namespace ski
