// Shared pieces of the FFT kernels: the odd-radix cross-DFT levels in
// registers, and a block-wide min/max reduction.
//
// Counterpart of the mixed-radix levels of fft_restoration_tpu/ops/
// pallas/fft_kernel.py (_cross_dft_level, _mixed_cross_fwd,
// _mixed_cross_inv; engine="roll"). The radix-2 stages themselves run in
// register groups (fft_groups.cuh: B1, B3/B6, B2/B7/B10; fft_cols.cu:
// B11; fft_radix4.cu: B12), the JAX package's arithmetic expression for
// expression:
//   DIF  (forward, stages long to short): a' = a + b, b' = (a - b) * w
//   DIT  (inverse, stages short to long): a' = a + w*b, b' = a - w*b
// with w = w_L^(j mod L/2) read from the float64-built tables (no
// in-kernel sincosf, so the twiddles match the JAX package bit for bit).
//
// Mixed radix (a smooth row length n = R * q, R = R0 * R1 the product of
// the odd radices, q a power of two): the forward pass runs one cross
// level per radix, outermost first, then the DIF stages over log2(q); the
// inverse runs the DIT stages, then the inverse levels innermost first.
// After the levels each q-wide block of a row is an independent q-point
// problem, so the radix-2 stages see rows * R "q-rows" of q points and
// index them with shifts alone: no division per element.
//
// The cross levels run in ONE pass (cross_item): a thread item (row, b),
// b < q, holds the R elements b + j1*q + j0*q0 (q0 = n / R0) in registers
// and runs level 0's R0-point DFTs and twiddle plane, then level 1's, the
// same sums in the same order as _cross_dft_level. The radices are
// template arguments (the pads give (3,), (5,), (3, 3) and (3, 5)), so
// the element map costs no division at all. Every FFT kernel with cross
// levels (B1, B3/B6, B2/B7) runs them so, in its load and its store.
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

// The radix tuples the kernels take, as one code: 0 none, 1 (3,), 2 (5,),
// 3 (3, 3), 4 (3, 5); -1 for any other tuple (the C entries refuse it)
__host__ inline int radix_code(const CrossPlan& p) {
  if (p.levels == 0) return 0;
  if (p.levels == 1) return p.radix[0] == 3 ? 1 : p.radix[0] == 5 ? 2 : -1;
  if (p.radix[0] != 3) return -1;
  return p.radix[1] == 3 ? 3 : p.radix[1] == 5 ? 4 : -1;
}

// R-point DFT of x (registers), in place:
//   out[k] = sum_j x[j] * W_R^(sign*k*j),
// j ascending with the exact-1 coefficients skipped (the JAX order)
template <int R>
__device__ __forceinline__ void small_dft(float* xr, float* xi, const float* c,
                                          const float* s) {
  float yr[R], yi[R];
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
    yr[k] = ar;
    yi[k] = ai;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    xr[k] = yr[k];
    xi[k] = yi[k];
  }
}

__device__ __forceinline__ void twiddle(float* xr, float* xi,
                                        const float* __restrict__ tc,
                                        const float* __restrict__ ts, int i) {
  const float wc = __ldg(tc + i), ws = __ldg(ts + i);
  const float a = *xr, b = *xi;
  *xr = a * wc - b * ws;
  *xi = a * ws + b * wc;
}

// Both cross levels of one thread item in registers: x[j0 * R1 + j1] is
// element b + j1*q + j0*q0 of a row of n = R0 * R1 * q points (R1 = 1:
// one level, q0 = q). Forward: level 0's DFT over j0 then its twiddle
// plane, then level 1's (blocks of width q0, sub-blocks q). Inverse:
// level 1's conjugate twiddle then DFT, then level 0's. The same sums in
// the same order as the JAX levels, run one level after the other over
// the whole row.
template <int R0, int R1, bool INV>
__device__ __forceinline__ void cross_item(float* xr, float* xi, int b, int q,
                                           int n, const CrossPlan& p) {
  const int q0 = q * R1;
  const float* tc0 = p.xcos;
  const float* ts0 = p.xsin;
  const float* tc1 = p.xcos + n;
  const float* ts1 = p.xsin + n;
  float tr[R0 > R1 ? R0 : R1], ti[R0 > R1 ? R0 : R1];
  if (!INV) {
#pragma unroll
    for (int j1 = 0; j1 < R1; ++j1) {
#pragma unroll
      for (int j0 = 0; j0 < R0; ++j0) {
        tr[j0] = xr[j0 * R1 + j1];
        ti[j0] = xi[j0 * R1 + j1];
      }
      small_dft<R0>(tr, ti, p.c[0], p.s[0]);
#pragma unroll
      for (int k0 = 0; k0 < R0; ++k0) {
        twiddle(&tr[k0], &ti[k0], tc0, ts0, b + j1 * q + k0 * q0);
        xr[k0 * R1 + j1] = tr[k0];
        xi[k0 * R1 + j1] = ti[k0];
      }
    }
    if (R1 > 1) {
#pragma unroll
      for (int k0 = 0; k0 < R0; ++k0) {
        small_dft<R1>(xr + k0 * R1, xi + k0 * R1, p.c[1], p.s[1]);
#pragma unroll
        for (int k1 = 0; k1 < R1; ++k1)
          twiddle(&xr[k0 * R1 + k1], &xi[k0 * R1 + k1], tc1, ts1,
                  b + k1 * q + k0 * q0);
      }
    }
  } else {
    if (R1 > 1) {
#pragma unroll
      for (int k0 = 0; k0 < R0; ++k0) {
#pragma unroll
        for (int j1 = 0; j1 < R1; ++j1)
          twiddle(&xr[k0 * R1 + j1], &xi[k0 * R1 + j1], tc1, ts1,
                  b + j1 * q + k0 * q0);
        small_dft<R1>(xr + k0 * R1, xi + k0 * R1, p.c[1], p.s[1]);
      }
    }
#pragma unroll
    for (int j1 = 0; j1 < R1; ++j1) {
#pragma unroll
      for (int j0 = 0; j0 < R0; ++j0) {
        tr[j0] = xr[j0 * R1 + j1];
        ti[j0] = xi[j0 * R1 + j1];
        twiddle(&tr[j0], &ti[j0], tc0, ts0, b + j1 * q + j0 * q0);
      }
      small_dft<R0>(tr, ti, p.c[0], p.s[0]);
#pragma unroll
      for (int k0 = 0; k0 < R0; ++k0) {
        xr[k0 * R1 + j1] = tr[k0];
        xi[k0 * R1 + j1] = ti[k0];
      }
    }
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
