// Shared pieces of the row-FFT kernels: radix-2 stage loops and the
// odd-radix cross-DFT levels over rows held in shared memory, and a
// block-wide min/max reduction.
//
// Counterpart of the stage bodies of fft_restoration_tpu/ops/pallas/
// fft_kernel.py (_dif_stage, _dit_stage, _fft_stages; engine="roll") and
// of its mixed-radix levels (_cross_dft_level, _mixed_cross_fwd,
// _mixed_cross_inv). The TPU version pairs lanes with two lane rotations
// and a half mask; here one thread takes one butterfly (i0, i1 = i0 +
// half) of one row, so the mask becomes index arithmetic. The arithmetic
// is the same, expression for expression:
//   DIF  (forward, stages long to short): a' = a + b, b' = (a - b) * w
//   DIT  (inverse, stages short to long): a' = a + w*b, b' = a - w*b
// with w = w_L^(j mod L/2) read from the float64-built tables (no
// in-kernel sincosf, so the twiddles match the JAX package bit for bit).
//
// Mixed radix (a smooth row length n = prod(radices) * q, q a power of
// two; the MIXED template flag): the forward pass runs one cross level
// per radix, outermost first, then the DIF stages over log2(q); the
// inverse runs the DIT stages, then the inverse levels innermost first.
// A butterfly of length L <= q never crosses a q-block, so the stage
// formula holds; only the row index needs a division by n / 2 instead of
// a shift. With MIXED false the pow2 code is the shift/mask code it was.
//
// Layout: a block holds `rows` complex rows of length n as two planes,
// re[rows][n] then im[rows][n], in dynamic shared memory. Every stage and
// every cross level ends with __syncthreads(), so callers may touch the
// planes right after.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FFT_THREADS 512
// cross levels a kernel takes (the smooth pads' odd factors 3, 5, 9 = 3*3
// and 15 = 3*5 need at most two) and their radices, 3 or 5
#define MAX_CROSS_LEVELS 2
#define MAX_RADIX 5

// The cross levels of one direction, passed by value as a kernel
// argument: radix, the r-point DFT's coefficients W_r^(sign*m), m < r
// (float32 of float64 angles, built on the host as the stage tables are)
// and the (levels, n) four-step twiddle planes in device memory.
struct CrossPlan {
  int levels;
  int radix[MAX_CROSS_LEVELS];
  float c[MAX_CROSS_LEVELS][MAX_RADIX];
  float s[MAX_CROSS_LEVELS][MAX_RADIX];
  const float* xcos;
  const float* xsin;
};

// levels 0 (a pow2 length) leaves the pointers unread; coef holds per
// level MAX_RADIX cosines then MAX_RADIX sines
__host__ inline CrossPlan make_cross_plan(int levels, const int* radix,
                                          const float* coef, const void* xcos,
                                          const void* xsin) {
  CrossPlan p = {};
  p.levels = levels;
  for (int l = 0; l < levels; ++l) {
    p.radix[l] = radix[l];
    for (int m = 0; m < MAX_RADIX; ++m) {
      p.c[l][m] = coef[(2 * l) * MAX_RADIX + m];
      p.s[l][m] = coef[(2 * l + 1) * MAX_RADIX + m];
    }
  }
  p.xcos = (const float*)xcos;
  p.xsin = (const float*)xsin;
  return p;
}

// Split butterfly index t of rows * n/2 into (row, index in the row).
template <bool MIXED>
__device__ __forceinline__ void split_half(int t, int half_n, int log2n,
                                           int* r, int* b) {
  if (MIXED) {
    *r = t / half_n;
    *b = t - *r * half_n;
  } else {
    *r = t >> (log2n - 1);
    *b = t & (half_n - 1);
  }
}

// stages: log2(n) for a pow2 n, log2(q) for a mixed one
template <bool MIXED>
__device__ __forceinline__ void dif_stages(float* re, float* im, int rows,
                                           int n, int stages,
                                           const float* __restrict__ cosv,
                                           const float* __restrict__ sinv) {
  const int half_n = n >> 1;
  const int total = rows * half_n;
  for (int s = stages - 1; s >= 0; --s) {
    const int half = 1 << s;
    const float* wc = cosv + (size_t)s * n;
    const float* ws = sinv + (size_t)s * n;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      int r, b;
      split_half<MIXED>(t, half_n, stages, &r, &b);
      const int pos = b & (half - 1);
      const int i0 = r * n + ((b >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
      const float c = __ldg(wc + pos), sn = __ldg(ws + pos);
      const float dr = ar - br, di = ai - bi;
      re[i0] = ar + br;
      im[i0] = ai + bi;
      re[i1] = c * dr - sn * di;
      im[i1] = c * di + sn * dr;
    }
    __syncthreads();
  }
}

template <bool MIXED>
__device__ __forceinline__ void dit_stages(float* re, float* im, int rows,
                                           int n, int stages,
                                           const float* __restrict__ cosv,
                                           const float* __restrict__ sinv) {
  const int half_n = n >> 1;
  const int total = rows * half_n;
  for (int s = 0; s < stages; ++s) {
    const int half = 1 << s;
    const float* wc = cosv + (size_t)s * n;
    const float* ws = sinv + (size_t)s * n;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      int r, b;
      split_half<MIXED>(t, half_n, stages, &r, &b);
      const int pos = b & (half - 1);
      const int i0 = r * n + ((b >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
      const float c = __ldg(wc + pos), sn = __ldg(ws + pos);
      const float wr = c * br - sn * bi, wi = c * bi + sn * br;
      re[i0] = ar + wr;
      im[i0] = ai + wi;
      re[i1] = ar - wr;
      im[i1] = ai - wi;
    }
    __syncthreads();
  }
}

// One cross level over `rows` rows of length n: the R-point DFT across
// the q-wide sub-blocks (q = w / R) of every w-wide block of a row,
//   out[base + k1*q + j2] = sum_j1 x[base + j1*q + j2] * W_R^(sign*k1*j1),
// j1 ascending with the exact-1 coefficients skipped (the JAX order).
// One thread takes one (row, block, j2): it reads the R values into
// registers and writes the R outputs back to the same slots, so the
// level runs in place. Forward: the DFT, then the level's twiddle plane;
// inverse: the (conjugate) twiddle plane, then the DFT with the inverse
// coefficients.
template <int R, bool INV>
__device__ __forceinline__ void cross_level(float* re, float* im, int rows,
                                            int n, int w, const float* c,
                                            const float* s,
                                            const float* __restrict__ tc,
                                            const float* __restrict__ ts) {
  const int q = w / R;
  const int per_row = n / R;
  const int total = rows * per_row;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int row = t / per_row;
    const int rem = t - row * per_row;
    const int blk = rem / q;
    const int pos = blk * w + (rem - blk * q);  // slot of j1 = 0 in the row
    float* xre = re + row * n;
    float* xim = im + row * n;
    float xr[R], xi[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = pos + j * q;
      const float a = xre[i], b = xim[i];
      if (INV) {
        const float wc = __ldg(tc + i), ws = __ldg(ts + i);
        xr[j] = a * wc - b * ws;
        xi[j] = a * ws + b * wc;
      } else {
        xr[j] = a;
        xi[j] = b;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float ar = xr[0], ai = xi[0];
#pragma unroll
      for (int j = 1; j < R; ++j) {
        const int m = (k * j) % R;
        if (m == 0) {
          ar += xr[j];
          ai += xi[j];
        } else {
          ar += c[m] * xr[j] - s[m] * xi[j];
          ai += c[m] * xi[j] + s[m] * xr[j];
        }
      }
      const int i = pos + k * q;
      if (INV) {
        xre[i] = ar;
        xim[i] = ai;
      } else {
        const float wc = __ldg(tc + i), ws = __ldg(ts + i);
        xre[i] = ar * wc - ai * ws;
        xim[i] = ar * ws + ai * wc;
      }
    }
  }
  __syncthreads();
}

template <bool INV>
__device__ __forceinline__ void cross_level_l(float* re, float* im, int rows,
                                              int n, int w, const CrossPlan& p,
                                              int l) {
  const float* tc = p.xcos + (size_t)l * n;
  const float* ts = p.xsin + (size_t)l * n;
  if (p.radix[l] == 3) {
    cross_level<3, INV>(re, im, rows, n, w, p.c[l], p.s[l], tc, ts);
  } else {
    cross_level<5, INV>(re, im, rows, n, w, p.c[l], p.s[l], tc, ts);
  }
}

// Forward: levels outermost first (level l splits blocks of width
// w_l = n / prod(radix[:l])). Run before the DIF stages.
__device__ __forceinline__ void cross_fwd(float* re, float* im, int rows,
                                          int n, const CrossPlan& p) {
  int w = n;
#pragma unroll
  for (int l = 0; l < MAX_CROSS_LEVELS; ++l) {
    if (l < p.levels) {
      cross_level_l<false>(re, im, rows, n, w, p, l);
      w /= p.radix[l];
    }
  }
}

// Inverse: levels innermost first, after the DIT stages.
__device__ __forceinline__ void cross_inv(float* re, float* im, int rows,
                                          int n, const CrossPlan& p) {
  int w[MAX_CROSS_LEVELS];
  w[0] = n;
#pragma unroll
  for (int l = 1; l < MAX_CROSS_LEVELS; ++l) {
    w[l] = l < p.levels ? w[l - 1] / p.radix[l - 1] : 0;
  }
#pragma unroll
  for (int l = MAX_CROSS_LEVELS - 1; l >= 0; --l) {
    if (l < p.levels) cross_level_l<true>(re, im, rows, n, w[l], p, l);
  }
}

// Reduce v = {min_re, max_re, min_im, max_im} over the block; thread 0
// writes the four values to out. blockDim.x must be a multiple of 32.
__device__ __forceinline__ void block_minmax4(float v[4], float* out) {
  __shared__ float red[FFT_THREADS / 32][4];
  for (int o = 16; o > 0; o >>= 1) {
    v[0] = fminf(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
    v[1] = fmaxf(v[1], __shfl_xor_sync(0xffffffffu, v[1], o));
    v[2] = fminf(v[2], __shfl_xor_sync(0xffffffffu, v[2], o));
    v[3] = fmaxf(v[3], __shfl_xor_sync(0xffffffffu, v[3], o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    for (int i = 0; i < 4; ++i) red[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float r[4] = {red[0][0], red[0][1], red[0][2], red[0][3]};
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      r[0] = fminf(r[0], red[w][0]);
      r[1] = fmaxf(r[1], red[w][1]);
      r[2] = fminf(r[2], red[w][2]);
      r[3] = fmaxf(r[3], red[w][3]);
    }
    for (int i = 0; i < 4; ++i) out[i] = r[i];
  }
}

// Raise a kernel's dynamic shared memory limit (needed above 48 KB).
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
