// fft_rows: radix-2 row FFT over the last axis, all stages in shared memory.
//
// Replaces three Pallas kernels of fft_restoration_tpu/ops/pallas/
// fft_kernel.py that share one stage body (_run_stages) and differ only
// in how they load and store:
//   B1 _fft_rows_transposed ("fftr_rows_T_fwd")  -> load u8/f32, STORE_T
//   B6 fft_rows_pallas plain path ("fftr_rows_*") -> STORE_NATURAL
//   B3 fft_rows_packed_out ("fftr_rows_packed_inv") -> STORE_PACKED + min/max
// Ordering revorder: forward = DIF (natural in, bit-reversed out),
// inverse = DIT (bit-reversed in, natural out), unscaled. Natural
// ordering (the NATURAL instances, pow2 N; B6's ordering="natural", the
// generic API's `pallas` backend): the loader writes element c of a row to
// shared slot bit-reverse(c), so the bit reversal costs no pass of its
// own, and the DIT stages then run with the direction's tables (the JAX
// kernel's XLA bit-reversal pass, then DIT; fft_kernel.py:1042-1049).
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
// Load: pair p reads logical plane q = p*qstep as re and q + qim as im,
// each from its own base pointer, element (q, m, c) at
//   (q / channels) * is + (q % channels) * chs + m * rs + c * cs
// when the pair is live (p < re_live, p < im_live), m < live_rows and
// c < live_cols, else 0. The (image, channel) map makes one loader serve
// contiguous (P, M, N) planes (channels = 1, qstep = 1), the even/odd
// channel planes of one (H, W, 3) frame, and a (B, H, W, 3) image stack
// whose channel pairs straddle images (channels = 3, qstep = 2, qim = 1:
// plane q is image q / 3, channel q % 3), all with their zero pad and no
// copy. uint8 converts as x / 255.0f, a true division, as the TPU
// kernel's _load_f32 does.
//
// Grid: one dimension, block b takes row block b % nblk of pair b / nblk,
// so the pair count is not held to gridDim.y's 65535 (a CLI chunk of
// small frames packs hundreds of thousands of pairs).
//
// Mixed radix (--pad smooth; B-mixed, fft_kernel.py:139-217): a row
// length N = prod(radices) * 2^k runs the cross levels of fft_common.cuh
// before the DIF stages (forward) or after the DIT stages (inverse), in
// the instance compiled with MIXED; the load and the natural store then
// split t by division by N instead of a shift. The levels add one
// shared-memory pass each (r reads and writes per element, 8r - 2 flops
// per output) to the 2*log2(q) of the stages, so the kernel stays bound
// by shared memory and barriers; a pow2 N takes the MIXED = false
// instance, the code it had before.
#include "fft_common.cuh"

enum { STORE_NATURAL = 0, STORE_T = 1, STORE_PACKED = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return (float)v / 255.0f; }

// row of element t of a block's rows * N (log2n: log2(N) when !MIXED)
template <bool MIXED>
__device__ __forceinline__ int row_of(int t, int N, int log2n) {
  return MIXED ? t / N : t >> log2n;
}

template <bool MIXED>
__device__ __forceinline__ int col_of(int t, int r, int N) {
  return MIXED ? t - r * N : t & (N - 1);
}

// stages: log2(N), or log2 of the pow2 tail when MIXED; NATURAL only
// without MIXED
template <typename T, bool MIXED, bool NATURAL>
__global__ void __launch_bounds__(FFT_THREADS)
fft_rows_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                long long is, long long chs, int channels, int qstep, int qim,
                long long rs, long long cs, int re_live, int im_live,
                int live_rows, int live_cols, int M, int N, int stages,
                int rows, int nblk, float* __restrict__ out_re,
                float* __restrict__ out_im, float* __restrict__ minmax,
                int store, int inverse, const float* __restrict__ cosv,
                const float* __restrict__ sinv,
                const __grid_constant__ CrossPlan plan) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + rows * N;
  const int p = blockIdx.x / nblk;
  const int blk = blockIdx.x - p * nblk;
  const int m0 = blk * rows;
  const int total = rows * N;
  const bool re_ok = p < re_live;
  const bool im_ok = src_im != nullptr && p < im_live;
  const int q_re = p * qstep, q_im = p * qstep + qim;
  const long long base_re =
      (long long)(q_re / channels) * is + (long long)(q_re % channels) * chs;
  const long long base_im =
      (long long)(q_im / channels) * is + (long long)(q_im % channels) * chs;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = row_of<MIXED>(t, N, stages);
    const int m = m0 + r;
    const int c = col_of<MIXED>(t, r, N);
    const bool live = m < live_rows && c < live_cols;
    const long long off = m * rs + c * cs;
    const int slot =
        NATURAL ? r * N + (int)(__brev((unsigned)c) >> (32 - stages)) : t;
    sre[slot] = (live && re_ok) ? to_f32(src_re[base_re + off]) : 0.0f;
    sim[slot] = (live && im_ok) ? to_f32(src_im[base_im + off]) : 0.0f;
  }
  __syncthreads();

  if (NATURAL || inverse) {
    dit_stages<MIXED>(sre, sim, rows, N, stages, cosv, sinv);
    if (MIXED) cross_inv(sre, sim, rows, N, plan);
  } else {
    if (MIXED) cross_fwd(sre, sim, rows, N, plan);
    dif_stages<MIXED>(sre, sim, rows, N, stages, cosv, sinv);
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
      const int r = row_of<MIXED>(t, N, stages);
      const int m = m0 + r;
      if (m < M) {
        const size_t o = ((size_t)p * M + m) * N + col_of<MIXED>(t, r, N);
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
    block_minmax4(v, minmax + ((size_t)p * nblk + blk) * 4);
  }
}

template <typename T, bool MIXED, bool NATURAL>
static int launch(const void* src_re, const void* src_im, long long is,
                  long long chs, int channels, int qstep, int qim,
                  long long rs, long long cs, int re_live, int im_live,
                  int live_rows, int live_cols, int P, int M, int N, int stages,
                  int rows, void* out_re, void* out_im, void* minmax, int store,
                  int inverse, const void* cosv, const void* sinv,
                  const CrossPlan& plan, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)rows * N * sizeof(float);
  cudaError_t err = allow_smem(fft_rows_kernel<T, MIXED, NATURAL>, smem);
  if (err != cudaSuccess) return (int)err;
  const int covered = live_rows < M ? live_rows : M;
  const int nblk = (covered + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fft_rows_kernel<T, MIXED, NATURAL><<<nblk * P, FFT_THREADS, smem, stream>>>(
      (const T*)src_re, (const T*)src_im, is, chs, channels, qstep, qim, rs,
      cs, re_live, im_live, live_rows, live_cols, M, N, stages, rows, nblk,
      (float*)out_re, (float*)out_im, (float*)minmax, store, inverse,
      (const float*)cosv, (const float*)sinv, plan);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_any(const void* src_re, const void* src_im, long long is,
                      long long chs, int channels, int qstep, int qim,
                      long long rs, long long cs, int re_live, int im_live,
                      int live_rows, int live_cols, int P, int M, int N,
                      int stages, int rows, void* out_re, void* out_im,
                      void* minmax, int store, int inverse, int natural,
                      const void* cosv, const void* sinv, const CrossPlan& plan,
                      cudaStream_t stream) {
  if (natural) {
    if (plan.levels > 0) return (int)cudaErrorInvalidValue;  // pow2 only
    return launch<T, false, true>(src_re, src_im, is, chs, channels, qstep, qim,
                                  rs, cs, re_live, im_live, live_rows, live_cols,
                                  P, M, N, stages, rows, out_re, out_im, minmax,
                                  store, inverse, cosv, sinv, plan, stream);
  }
  if (plan.levels > 0)
    return launch<T, true, false>(src_re, src_im, is, chs, channels, qstep, qim,
                                  rs, cs, re_live, im_live, live_rows, live_cols,
                                  P, M, N, stages, rows, out_re, out_im, minmax,
                                  store, inverse, cosv, sinv, plan, stream);
  return launch<T, false, false>(src_re, src_im, is, chs, channels, qstep, qim,
                                 rs, cs, re_live, im_live, live_rows, live_cols,
                                 P, M, N, stages, rows, out_re, out_im, minmax,
                                 store, inverse, cosv, sinv, plan, stream);
}

// levels, radix, coef, xcos, xsin: the cross levels of this direction
// (levels 0 for a pow2 N; see make_cross_plan); natural: natural ordering
// (pow2 N, levels 0)
extern "C" int fft_rows_launch(const void* src_re, const void* src_im,
                               int in_u8, long long is, long long chs,
                               int channels, int qstep, int qim, long long rs,
                               long long cs, int re_live, int im_live,
                               int live_rows, int live_cols, int P, int M,
                               int N, int stages, int rows, void* out_re,
                               void* out_im, void* minmax, int store,
                               int inverse, int natural, const void* cosv,
                               const void* sinv, int levels, const int* radix,
                               const float* coef, const void* xcos,
                               const void* xsin, void* stream) {
  if (levels < 0 || levels > MAX_CROSS_LEVELS) return (int)cudaErrorInvalidValue;
  const CrossPlan plan = make_cross_plan(levels, radix, coef, xcos, xsin);
  if (in_u8) {
    return launch_any<uint8_t>(src_re, src_im, is, chs, channels, qstep, qim,
                               rs, cs, re_live, im_live, live_rows, live_cols,
                               P, M, N, stages, rows, out_re, out_im, minmax,
                               store, inverse, natural, cosv, sinv, plan,
                               (cudaStream_t)stream);
  }
  return launch_any<float>(src_re, src_im, is, chs, channels, qstep, qim, rs,
                           cs, re_live, im_live, live_rows, live_cols, P, M, N,
                           stages, rows, out_re, out_im, minmax, store,
                           inverse, natural, cosv, sinv, plan,
                           (cudaStream_t)stream);
}
