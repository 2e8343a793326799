// fft_radix4: forward row FFT with radix-4 DIF stages and a radix-2 tail.
//
// Replaces fft_restoration_tpu/ops/pallas/fft_radix4.py:fft_rows_radix4_fwd
// (B12, "fftr_radix4_fwd"), the JAX package's experiment on whether
// radix-4 helps (tools/perf_ab.py radix4). Natural input, mixed-radix
// digit-reversed output: the stage lengths run long to short, radix 4
// while L % 4 == 0 (n = 4^a * 2^b), then radix-2 stages for what is left
// (b <= 1 of them: at n = 2048 five radix-4 stages and one radix-2), so
// the output order is the JAX kernel's exactly
// (radix4_output_permutation).
//
// A radix-4 stage of length L, q = L / 4: one thread takes one (row,
// block, j), j < q. It reads a, b, c, d at slots j, j+q, j+2q, j+3q of its
// L-block, forms t1 = a+c, t2 = a-c, t3 = b+d, t4 = b-d, then
//   y0 = t1 + t3, y1 = t2 - i*t4, y2 = t1 - t3, y3 = t2 + i*t4
// (fft_radix4.py:98-104) and writes y_k * W_L^(j*k) back to the four slots,
// W from the float32 tables of _r4_tables_np (a lane plane per stage, no
// sincosf), in the JAX operation order. The radix-2 tail is
// fft_common.cuh's DIF stage on the forward tables (its division-indexed
// instance, since the tail's stage count is not log2(n)). Real input
// (im null) loads zeros.
//
// What bounds it on the H100: it moves what a forward fft_rows pass moves
// (a real (6144, 2048) input: 50 MB in, 101 MB out, 45 us at 3.35 TB/s),
// with half the stage passes and barriers of radix 2 (6 against 11 at n =
// 2048) but four complex values per thread in registers. The stages stay
// in shared memory, rows per block as fft_rows (64 KB).
#include "fft_common.cuh"

__global__ void __launch_bounds__(FFT_THREADS)
fft_radix4_kernel(const float* __restrict__ src_re,
                  const float* __restrict__ src_im, float* __restrict__ out_re,
                  float* __restrict__ out_im, int B, int N, int log2n,
                  int r4_stages, int tail_stages, int rows,
                  const float* __restrict__ c4, const float* __restrict__ s4,
                  const float* __restrict__ c2, const float* __restrict__ s2) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + rows * N;
  const int row0 = blockIdx.x * rows;
  const int total = rows * N;
  const int live = (B - row0 < rows ? B - row0 : rows) * N;
  const size_t base = (size_t)row0 * N;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const bool ok = t < live;
    sre[t] = ok ? src_re[base + t] : 0.0f;
    sim[t] = (ok && src_im != nullptr) ? src_im[base + t] : 0.0f;
  }
  __syncthreads();

  const int quarter_n = N >> 2;
  const int per_block = rows * quarter_n;
  for (int s = 0; s < r4_stages; ++s) {
    const int log2q = log2n - 2 * s - 2;  // q = L / 4, L = N >> 2s
    const int q = 1 << log2q;
    const float* wc = c4 + (size_t)s * N;
    const float* ws = s4 + (size_t)s * N;
    for (int t = threadIdx.x; t < per_block; t += blockDim.x) {
      const int r = t >> (log2n - 2);
      const int u = t & (quarter_n - 1);
      const int lane = ((u >> log2q) << (log2q + 2)) + (u & (q - 1));  // blk*L + j
      float* xr = sre + r * N;
      float* xi = sim + r * N;
      const float ar = xr[lane], ai = xi[lane];
      const float br = xr[lane + q], bi = xi[lane + q];
      const float cr = xr[lane + 2 * q], ci = xi[lane + 2 * q];
      const float dr = xr[lane + 3 * q], di = xi[lane + 3 * q];
      const float t1r = ar + cr, t1i = ai + ci;
      const float t2r = ar - cr, t2i = ai - ci;
      const float t3r = br + dr, t3i = bi + di;
      const float t4r = br - dr, t4i = bi - di;
      const float yr[4] = {t1r + t3r, t2r + t4i, t1r - t3r, t2r - t4i};
      const float yi[4] = {t1i + t3i, t2i - t4r, t1i - t3i, t2i + t4r};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane + k * q;
        const float cw = __ldg(wc + i), sw = __ldg(ws + i);
        xr[i] = yr[k] * cw - yi[k] * sw;
        xi[i] = yr[k] * sw + yi[k] * cw;
      }
    }
    __syncthreads();
  }
  dif_stages(sre, sim, rows * (N >> tail_stages), tail_stages, N, c2, s2);

  for (int t = threadIdx.x; t < live; t += blockDim.x) {
    out_re[base + t] = sre[t];
    out_im[base + t] = sim[t];
  }
}

// B rows of N = 2^log2n points (N >= 4), `rows` rows a block; c4/s4 the
// (r4_stages, N) radix-4 tables, c2/s2 the (log2n, N) radix-2 forward
// tables (the tail reads their first tail_stages planes); src_im null for
// a real input
extern "C" int fft_radix4_launch(const void* re, const void* im, void* out_re,
                                 void* out_im, int B, int N, int log2n,
                                 int r4_stages, int tail_stages, int rows,
                                 const void* c4, const void* s4, const void* c2,
                                 const void* s2, void* stream) {
  if (N < 4 || N != (1 << log2n) || rows < 1 || 2 * r4_stages + tail_stages != log2n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)rows * N * sizeof(float);
  cudaError_t err = allow_smem(fft_radix4_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + rows - 1) / rows;
  fft_radix4_kernel<<<blocks, FFT_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)re, (const float*)im, (float*)out_re, (float*)out_im, B, N,
      log2n, r4_stages, tail_stages, rows, (const float*)c4, (const float*)s4,
      (const float*)c2, (const float*)s2);
  return (int)cudaGetLastError();
}
