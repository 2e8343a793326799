// fft_rows: radix-2 row FFT over the last axis, all stages in shared
// memory, for the natural and packed stores.
//
// Replaces two Pallas kernels of fft_restoration_tpu/ops/pallas/
// fft_kernel.py that share one stage body (_run_stages) and differ only
// in how they store:
//   B6 fft_rows_pallas plain path ("fftr_rows_*") -> STORE_NATURAL
//   B3 fft_rows_packed_out ("fftr_rows_packed_inv") -> STORE_PACKED + min/max
// The third, B1 _fft_rows_transposed ("fftr_rows_T_fwd"), the transposed
// store, is fft_rows_t.cu's register-resident kernel.
// Ordering revorder: forward = DIF (natural in, bit-reversed out),
// inverse = DIT (bit-reversed in, natural out), unscaled. Natural
// ordering (the NATURAL instances, pow2 N; B6's ordering="natural", the
// generic API's `pallas` backend): the loader writes element c of a row to
// shared slot bit-reverse(c), so the bit reversal costs no pass of its
// own, and the DIT stages then run with the direction's tables (the JAX
// kernel's XLA bit-reversal pass, then DIT; fft_kernel.py:1042-1049).
//
// What bounds it on the H100: each row is read and written once, so a
// pass over two complex 2048^2 planes moves 134 MB, 40 us at 3.35 TB/s;
// the log2(n) stages of shared-memory butterflies (11 at n=2048, 10 flops
// and 8 shared accesses per butterfly) cost more than that, so the kernel
// is bound by shared-memory traffic and the __syncthreads() between
// stages, not by device memory. The design keeps the whole row resident
// in shared memory for all stages (one device round trip per pass, as the
// TPU kernel keeps it in VMEM) and sizes rows-per-block (a power of two
// chosen by the wrapper) to 64 KB of shared memory so several blocks share
// an SM. Its stages are the next redesign (ROADMAP.md B).
//
// Load: pair p reads logical plane q = p*qstep as re and q + qim as im,
// each from its own base pointer, element (q, m, c) at
//   (q / channels) * is + (q % channels) * chs + m * rs + c * cs
// when the pair is live (p < re_live, p < im_live), m < live_rows and
// c < live_cols, else 0 (the loader shared with fft_rows_t.cu, in
// fft_rows_load.cuh). uint8 converts as x / 255.0f, a true division, as
// the TPU kernel's _load_f32 does.
//
// Grid: one dimension, block b takes row block b % nblk of pair b / nblk,
// so the pair count is not held to gridDim.y's 65535 (a CLI chunk of
// small frames packs hundreds of thousands of pairs).
//
// Mixed radix (--pad smooth; B-mixed, fft_kernel.py:139-217): a row
// length N = R * 2^k runs both cross levels in one shared-memory pass
// (fft_common.cuh cross_pass) before the DIF stages (forward) or after the
// DIT stages (inverse), in the instance compiled with MIXED; the load, the
// stages and the stores index the rows' R q-blocks with shifts alone.
#include "fft_common.cuh"
#include "fft_rows_load.cuh"

enum { STORE_NATURAL = 0, STORE_PACKED = 2 };

// element t of a block's rows * N as (row, column): column b + j*q with
// b = t mod q fastest (coalesced), then the row, then the q-block j
__device__ __forceinline__ void row_col(int t, int logq, int lr, int* r, int* c) {
  *r = (t >> logq) & ((1 << lr) - 1);
  *c = (t & ((1 << logq) - 1)) + ((t >> (logq + lr)) << logq);
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
  const int lr = __ffs(rows) - 1;
  const PairLoad<T> ld(src_re, src_im, is, chs, channels, qstep, qim, rs, cs,
                       re_live, im_live, live_rows, live_cols, p, m0);

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    int r, c;
    row_col(t, stages, lr, &r, &c);
    const int slot =
        r * N + (NATURAL ? (int)(__brev((unsigned)c) >> (32 - stages)) : c);
    const float2 v = ld.get(r, c);
    sre[slot] = v.x;
    sim[slot] = v.y;
  }
  __syncthreads();

  const int qrows = rows * (N >> stages);  // R q-rows a row when MIXED
  if (NATURAL || inverse) {
    dit_stages(sre, sim, qrows, stages, N, cosv, sinv);
    if (MIXED) cross_pass_any<true>(sre, sim, rows, stages, plan);
  } else {
    if (MIXED) cross_pass_any<false>(sre, sim, rows, stages, plan);
    dif_stages(sre, sim, qrows, stages, N, cosv, sinv);
  }

  if (store == STORE_NATURAL) {
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      int r, c;
      row_col(t, stages, lr, &r, &c);
      const int m = m0 + r;
      if (m < M) {
        const size_t o = ((size_t)p * M + m) * N + c;
        out_re[o] = sre[r * N + c];
        out_im[o] = sim[r * N + c];
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
  if (radix_code(plan) < 0 || (store != STORE_NATURAL && store != STORE_PACKED))
    return (int)cudaErrorInvalidValue;
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
