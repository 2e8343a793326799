// wiener_spectral_t: column FFT -> Wiener -> column IFFT -> transposed write.
//
// Replaces fft_restoration_tpu/ops/pallas/wiener_spectral.py:
// wiener_spectral_rows_t ("fftr_spectral_mid_T_wiener", B2). In the
// transposed orientation the middle of the 2D restore works on each row
// on its own: per block of rows it runs the DIF stages (the second
// forward pass), F = G * conj(H) / (|H|^2 + K) against the matching rows
// of the PSF spectrum, then the DIT stages (the first inverse pass), and
// writes the block transposed, ready for the final row IFFT. The
// filtered 2D spectrum never goes to device memory.
//
// What bounds it on the H100: it reads A (67 MB at 2048^2 x 2 planes)
// and H (34 MB) and writes the result (67 MB), about 50 us at 3.35 TB/s;
// its 2*log2(n) shared-memory butterfly stages cost more,
// so like fft_rows it is bound by shared-memory traffic and the barriers
// between stages. The design keeps each row block in shared memory from
// the first stage to the store, so the fusion saves two full device
// round trips of the spectrum (what the TPU kernel saves in VMEM).
#include "fft_common.cuh"

__global__ void __launch_bounds__(FFT_THREADS)
wiener_spectral_t_kernel(const float* __restrict__ a_re,
                         const float* __restrict__ a_im,
                         const float* __restrict__ h_re,
                         const float* __restrict__ h_im, float K,
                         float* __restrict__ out_re, float* __restrict__ out_im,
                         int M, int N, int log2n, int rows,
                         const float* __restrict__ cos_f,
                         const float* __restrict__ sin_f,
                         const float* __restrict__ cos_i,
                         const float* __restrict__ sin_i) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + rows * N;
  const int p = blockIdx.y;
  const int m0 = blockIdx.x * rows;
  const int total = rows * N;
  const size_t base = ((size_t)p * M + m0) * N;
  const size_t hbase = (size_t)m0 * N;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    sre[t] = a_re[base + t];
    sim[t] = a_im[base + t];
  }
  __syncthreads();
  dif_stages(sre, sim, rows, N, log2n, cos_f, sin_f);

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const float hr = h_re[hbase + t], hi = h_im[hbase + t];
    const float xr = sre[t], xi = sim[t];
    const float inv = 1.0f / (hr * hr + hi * hi + K);
    sre[t] = (xr * hr + xi * hi) * inv;
    sim[t] = (xi * hr - xr * hi) * inv;
  }
  __syncthreads();
  dit_stages(sre, sim, rows, N, log2n, cos_i, sin_i);

  // (P, M, N) -> (P, N, M)
  const int log2rows = __ffs(rows) - 1;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t & (rows - 1);
    const int k = t >> log2rows;
    const size_t o = ((size_t)p * N + k) * M + m0 + r;
    out_re[o] = sre[r * N + k];
    out_im[o] = sim[r * N + k];
  }
}

extern "C" int wiener_spectral_t_launch(const void* a_re, const void* a_im,
                                        const void* h_re, const void* h_im,
                                        float K, void* out_re, void* out_im,
                                        int P, int M, int N, int log2n,
                                        int rows, const void* cos_f,
                                        const void* sin_f, const void* cos_i,
                                        const void* sin_i, void* stream) {
  const size_t smem = 2 * (size_t)rows * N * sizeof(float);
  cudaError_t err = allow_smem(wiener_spectral_t_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(M / rows, P);
  wiener_spectral_t_kernel<<<grid, FFT_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)a_re, (const float*)a_im, (const float*)h_re,
      (const float*)h_im, K, (float*)out_re, (float*)out_im, M, N, log2n, rows,
      (const float*)cos_f, (const float*)sin_f, (const float*)cos_i,
      (const float*)sin_i);
  return (int)cudaGetLastError();
}
