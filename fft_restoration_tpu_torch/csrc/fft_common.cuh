// Shared pieces of the row-FFT kernels: radix-2 stage loops over rows
// held in shared memory, and a block-wide min/max reduction.
//
// Counterpart of the stage bodies of fft_restoration_tpu/ops/pallas/
// fft_kernel.py (_dif_stage, _dit_stage, _fft_stages; engine="roll").
// The TPU version pairs lanes with two lane rotations and a half mask;
// here one thread takes one butterfly (i0, i1 = i0 + half) of one row,
// so the mask becomes index arithmetic. The arithmetic is the same,
// expression for expression:
//   DIF  (forward, stages long to short): a' = a + b, b' = (a - b) * w
//   DIT  (inverse, stages short to long): a' = a + w*b, b' = a - w*b
// with w = w_L^(j mod L/2) read from the float64-built tables (no
// in-kernel sincosf, so the twiddles match the JAX package bit for bit).
//
// Layout: a block holds `rows` complex rows of length n as two planes,
// re[rows][n] then im[rows][n], in dynamic shared memory. Every stage
// ends with __syncthreads(), so callers may touch the planes right after.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FFT_THREADS 512

__device__ __forceinline__ void dif_stages(float* re, float* im, int rows,
                                           int n, int log2n,
                                           const float* __restrict__ cosv,
                                           const float* __restrict__ sinv) {
  const int half_n = n >> 1;
  const int total = rows * half_n;
  for (int s = log2n - 1; s >= 0; --s) {
    const int half = 1 << s;
    const float* wc = cosv + (size_t)s * n;
    const float* ws = sinv + (size_t)s * n;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = t >> (log2n - 1);
      const int b = t & (half_n - 1);
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

__device__ __forceinline__ void dit_stages(float* re, float* im, int rows,
                                           int n, int log2n,
                                           const float* __restrict__ cosv,
                                           const float* __restrict__ sinv) {
  const int half_n = n >> 1;
  const int total = rows * half_n;
  for (int s = 0; s < log2n; ++s) {
    const int half = 1 << s;
    const float* wc = cosv + (size_t)s * n;
    const float* ws = sinv + (size_t)s * n;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = t >> (log2n - 1);
      const int b = t & (half_n - 1);
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
