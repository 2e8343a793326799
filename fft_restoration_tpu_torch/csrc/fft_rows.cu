// fft_rows: radix-2 row FFT over the last axis, all stages in shared memory.
//
// Replaces three Pallas kernels of fft_restoration_tpu/ops/pallas/
// fft_kernel.py that share one stage body (_run_stages) and differ only
// in how they load and store:
//   B1 _fft_rows_transposed ("fftr_rows_T_fwd")  -> load u8/f32, STORE_T
//   B6 fft_rows_pallas plain path ("fftr_rows_*") -> STORE_NATURAL
//   B3 fft_rows_packed_out ("fftr_rows_packed_inv") -> STORE_PACKED + min/max
// Ordering is always revorder: forward = DIF (natural in, bit-reversed
// out), inverse = DIT (bit-reversed in, natural out), unscaled.
//
// What bounds it on the H100: each row is read and written once, so a
// pass over two complex 2048^2 planes moves 80 MB (uint8 in) to 134 MB
// (float32 in), 24 to 40 us at 3.35 TB/s; the log2(n) stages of shared-memory butterflies
// (11 at n=2048, 10 flops and 8 shared accesses per butterfly) cost more
// than that, so the kernel is bound by shared-memory traffic and the
// __syncthreads() between stages, not by device memory. The design keeps
// the whole row resident in shared memory for all stages (one device
// round trip per pass, as the TPU kernel keeps it in VMEM), fuses the
// uint8 ingest, channel-pair packing, zero padding and the transpose into
// the load and store, and sizes rows-per-block (a power of two chosen by
// the wrapper) to 64 KB of shared memory so several blocks share an SM.
//
// Load: element (p, m, c) of the re (im) source is src[p*ps + m*rs + c*cs]
// when p < re_live (im_live), m < live_rows and c < live_cols, else 0.
// Strides make one loader serve contiguous (P, M, N) planes, even/odd
// channel planes of one array (channel-pair packing) and an interleaved
// (H, W, 3) uint8 frame with its zero pad. uint8 converts as x / 255.0f,
// a true division, as the TPU kernel's _load_f32 does.
#include "fft_common.cuh"

enum { STORE_NATURAL = 0, STORE_T = 1, STORE_PACKED = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return (float)v / 255.0f; }

template <typename T>
__global__ void __launch_bounds__(FFT_THREADS)
fft_rows_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                long long ps, long long rs, long long cs, int re_live,
                int im_live, int live_rows, int live_cols, int M, int N,
                int log2n, int rows, float* __restrict__ out_re,
                float* __restrict__ out_im, float* __restrict__ minmax,
                int store, int inverse, const float* __restrict__ cosv,
                const float* __restrict__ sinv) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + rows * N;
  const int p = blockIdx.y;
  const int m0 = blockIdx.x * rows;
  const int total = rows * N;
  const bool re_ok = p < re_live;
  const bool im_ok = src_im != nullptr && p < im_live;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int m = m0 + (t >> log2n);
    const int c = t & (N - 1);
    const bool live = m < live_rows && c < live_cols;
    const long long off = p * ps + m * rs + c * cs;
    sre[t] = (live && re_ok) ? to_f32(src_re[off]) : 0.0f;
    sim[t] = (live && im_ok) ? to_f32(src_im[off]) : 0.0f;
  }
  __syncthreads();

  if (inverse) {
    dit_stages(sre, sim, rows, N, log2n, cosv, sinv);
  } else {
    dif_stages(sre, sim, rows, N, log2n, cosv, sinv);
  }

  if (store == STORE_T) {
    // (P, M, N) -> (P, N, M): neighbouring threads take neighbouring rows
    // of one column, so each column writes `rows` consecutive floats
    const int log2rows = __ffs(rows) - 1;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = t & (rows - 1);
      const int k = t >> log2rows;
      const int m = m0 + r;
      if (m < M) {
        const size_t o = ((size_t)p * N + k) * M + m;
        out_re[o] = sre[r * N + k];
        out_im[o] = sim[r * N + k];
      }
    }
  } else if (store == STORE_NATURAL) {
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int m = m0 + (t >> log2n);
      if (m < M) {
        const size_t o = ((size_t)p * M + m) * N + (t & (N - 1));
        out_re[o] = sre[t];
        out_im[o] = sim[t];
      }
    }
  } else {
    // STORE_PACKED: re -> plane 2p, im -> plane 2p+1 of one (2P, M, N)
    // output, plus this block's [min_re, max_re, min_im, max_im]
    // (the wrapper guarantees M % rows == 0, so every row is live)
    float v[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};
    const size_t plane = (size_t)M * N;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const size_t o = 2 * p * plane + (size_t)m0 * N + t;
      const float xr = sre[t], xi = sim[t];
      out_re[o] = xr;
      out_re[o + plane] = xi;
      v[0] = fminf(v[0], xr);
      v[1] = fmaxf(v[1], xr);
      v[2] = fminf(v[2], xi);
      v[3] = fmaxf(v[3], xi);
    }
    block_minmax4(v, minmax + ((size_t)p * gridDim.x + blockIdx.x) * 4);
  }
}

template <typename T>
static int launch(const void* src_re, const void* src_im, long long ps,
                  long long rs, long long cs, int re_live, int im_live,
                  int live_rows, int live_cols, int P, int M, int N, int log2n,
                  int rows, void* out_re, void* out_im, void* minmax, int store,
                  int inverse, const void* cosv, const void* sinv,
                  cudaStream_t stream) {
  const size_t smem = 2 * (size_t)rows * N * sizeof(float);
  cudaError_t err = allow_smem(fft_rows_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int covered = live_rows < M ? live_rows : M;
  dim3 grid((covered + rows - 1) / rows, P);
  fft_rows_kernel<T><<<grid, FFT_THREADS, smem, stream>>>(
      (const T*)src_re, (const T*)src_im, ps, rs, cs, re_live, im_live,
      live_rows, live_cols, M, N, log2n, rows, (float*)out_re, (float*)out_im,
      (float*)minmax, store, inverse, (const float*)cosv, (const float*)sinv);
  return (int)cudaGetLastError();
}

extern "C" int fft_rows_launch(const void* src_re, const void* src_im,
                               int in_u8, long long ps, long long rs,
                               long long cs, int re_live, int im_live,
                               int live_rows, int live_cols, int P, int M,
                               int N, int log2n, int rows, void* out_re,
                               void* out_im, void* minmax, int store,
                               int inverse, const void* cosv, const void* sinv,
                               void* stream) {
  if (in_u8) {
    return launch<uint8_t>(src_re, src_im, ps, rs, cs, re_live, im_live,
                           live_rows, live_cols, P, M, N, log2n, rows, out_re,
                           out_im, minmax, store, inverse, cosv, sinv,
                           (cudaStream_t)stream);
  }
  return launch<float>(src_re, src_im, ps, rs, cs, re_live, im_live, live_rows,
                       live_cols, P, M, N, log2n, rows, out_re, out_im, minmax,
                       store, inverse, cosv, sinv, (cudaStream_t)stream);
}
