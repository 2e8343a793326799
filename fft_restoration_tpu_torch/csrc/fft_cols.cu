// fft_cols: radix-2 FFT down the columns (axis -2) of (L, H, W) planes.
//
// Replaces fft_restoration_tpu/ops/pallas/fft_kernel.py:fft_cols_pallas
// (B11, "fftr_cols_fwd/inv"), whose transform axis sits on the TPU's
// sublanes so that fft_rows_pallas then fft_cols_pallas make a 2D FFT with
// no transpose. Unscaled, in three orderings:
//   mode 0  revorder forward: DIF, natural in, bit-reversed out
//   mode 1  revorder inverse: DIT, bit-reversed in, natural out
//   mode 2  natural (either direction): the loader writes row h to shared
//           row bit-reverse(h), then DIT with the direction's tables (the
//           JAX kernel's XLA bit-reversal pass, then DIT)
// The stage arithmetic is fft_common.cuh's, expression for expression, on
// the float64-built tables of ops/kernels/fft_kernel.py:tables(H, inverse).
//
// Layout: one block takes a strip of `cols` adjacent columns (a power of
// two) of one plane, all H rows, in shared memory as re[H][cols] then
// im[H][cols]. Neighbouring threads take neighbouring columns of one row,
// so the loads and stores of a row segment are coalesced and the
// butterflies' shared accesses fall on consecutive words. A ragged last
// strip (W not a multiple of cols) is bounds-checked here; the JAX kernel
// pads W with a copy.
//
// What bounds it on the H100: each element is read and written once, 32 B
// a complex element in and out; three 2048^2 planes move 201 MB, 60 us
// at 3.35 TB/s. The log2(H) shared-memory stages and their barriers cost
// more, as in fft_rows. The strip is H * cols * 8 B: 128 KB at H = 2048
// with 8 columns (one block per SM), 4 columns at H = 4096, where a row
// segment is 16 B, half a 32-byte sector, so the tall case reads at half
// the efficiency (the wrapper's cols_per_block chooses; PERF.md).
//
// Grid: one dimension, block b takes strip b % nstrip of plane b / nstrip.
#include "fft_common.cuh"

// element (h, c) of a strip lies at (h << log2cols) + c
__device__ __forceinline__ void col_dif_stages(float* re, float* im, int H,
                                               int log2cols, int stages,
                                               const float* __restrict__ cosv,
                                               const float* __restrict__ sinv) {
  const int cols = 1 << log2cols;
  const int total = (H >> 1) << log2cols;
  for (int s = stages - 1; s >= 0; --s) {
    const int half = 1 << s;
    const float* wc = cosv + (size_t)s * H;
    const float* ws = sinv + (size_t)s * H;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int c = t & (cols - 1);
      const int b = t >> log2cols;
      const int pos = b & (half - 1);
      const int i0 = ((((b >> s) << (s + 1)) + pos) << log2cols) + c;
      const int i1 = i0 + (half << log2cols);
      const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
      const float cw = __ldg(wc + pos), sw = __ldg(ws + pos);
      const float dr = ar - br, di = ai - bi;
      re[i0] = ar + br;
      im[i0] = ai + bi;
      re[i1] = cw * dr - sw * di;
      im[i1] = cw * di + sw * dr;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void col_dit_stages(float* re, float* im, int H,
                                               int log2cols, int stages,
                                               const float* __restrict__ cosv,
                                               const float* __restrict__ sinv) {
  const int cols = 1 << log2cols;
  const int total = (H >> 1) << log2cols;
  for (int s = 0; s < stages; ++s) {
    const int half = 1 << s;
    const float* wc = cosv + (size_t)s * H;
    const float* ws = sinv + (size_t)s * H;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int c = t & (cols - 1);
      const int b = t >> log2cols;
      const int pos = b & (half - 1);
      const int i0 = ((((b >> s) << (s + 1)) + pos) << log2cols) + c;
      const int i1 = i0 + (half << log2cols);
      const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
      const float cw = __ldg(wc + pos), sw = __ldg(ws + pos);
      const float wr = cw * br - sw * bi, wi = cw * bi + sw * br;
      re[i0] = ar + wr;
      im[i0] = ai + wi;
      re[i1] = ar - wr;
      im[i1] = ai - wi;
    }
    __syncthreads();
  }
}

template <int MODE>
__global__ void __launch_bounds__(FFT_THREADS)
fft_cols_kernel(const float* __restrict__ src_re,
                const float* __restrict__ src_im, float* __restrict__ out_re,
                float* __restrict__ out_im, int H, int W, int stages,
                int log2cols, int nstrip, const float* __restrict__ cosv,
                const float* __restrict__ sinv) {
  extern __shared__ float smem[];
  const int cols = 1 << log2cols;
  float* sre = smem;
  float* sim = smem + (H << log2cols);
  const int p = blockIdx.x / nstrip;
  const int c0 = (blockIdx.x - p * nstrip) << log2cols;
  const size_t base = (size_t)p * H * W;
  const int total = H << log2cols;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int h = t >> log2cols;
    const int c = t & (cols - 1);
    const int col = c0 + c;
    const int slot =
        MODE == 2 ? ((int)(__brev((unsigned)h) >> (32 - stages)) << log2cols) + c : t;
    const bool live = col < W;
    const size_t o = base + (size_t)h * W + col;
    sre[slot] = live ? src_re[o] : 0.0f;
    sim[slot] = live ? src_im[o] : 0.0f;
  }
  __syncthreads();

  if (MODE == 0) {
    col_dif_stages(sre, sim, H, log2cols, stages, cosv, sinv);
  } else {
    col_dit_stages(sre, sim, H, log2cols, stages, cosv, sinv);
  }

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int col = c0 + (t & (cols - 1));
    if (col < W) {
      const size_t o = base + (size_t)(t >> log2cols) * W + col;
      out_re[o] = sre[t];
      out_im[o] = sim[t];
    }
  }
}

template <int MODE>
static int launch_cols(const void* re, const void* im, void* out_re,
                       void* out_im, int L, int H, int W, int stages, int cols,
                       const void* cosv, const void* sinv, cudaStream_t stream) {
  const int log2cols = __builtin_ctz((unsigned)cols);
  const size_t smem = 2 * (size_t)H * cols * sizeof(float);
  cudaError_t err = allow_smem(fft_cols_kernel<MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nstrip = (W + cols - 1) / cols;
  if ((long long)nstrip * L > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fft_cols_kernel<MODE><<<nstrip * L, FFT_THREADS, smem, stream>>>(
      (const float*)re, (const float*)im, (float*)out_re, (float*)out_im, H, W,
      stages, log2cols, nstrip, (const float*)cosv, (const float*)sinv);
  return (int)cudaGetLastError();
}

// L planes of (H, W), H = 2^stages, cols a power of two; mode as above;
// cos/sin: the (stages, H) tables of the transform's direction
extern "C" int fft_cols_launch(const void* re, const void* im, void* out_re,
                               void* out_im, int L, int H, int W, int stages,
                               int cols, int mode, const void* cosv,
                               const void* sinv, void* stream) {
  if (cols < 1 || (cols & (cols - 1)) || H != (1 << stages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    return launch_cols<0>(re, im, out_re, out_im, L, H, W, stages, cols, cosv, sinv, s);
  if (mode == 1)
    return launch_cols<1>(re, im, out_re, out_im, L, H, W, stages, cols, cosv, sinv, s);
  if (mode == 2)
    return launch_cols<2>(re, im, out_re, out_im, L, H, W, stages, cols, cosv, sinv, s);
  return (int)cudaErrorInvalidValue;
}
