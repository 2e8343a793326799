// The spectral middles of the 2D restore, in the transposed orientation.
//
// spectral_t_kernel<MODE>: column FFT -> filter -> column IFFT ->
// transposed write. Replaces fft_restoration_tpu/ops/pallas/
// wiener_spectral.py:wiener_spectral_rows_t (B2) in both its modes:
//   MODE_WIENER     F = G * conj(H) / (|H|^2 + K)
//                   ("fftr_spectral_mid_T_wiener": the restore's middle)
//   MODE_CONV       F = G * H, K ignored ("fftr_spectral_mid_T_conv": the
//                   circular convolution of models/convolve.py, run by
//                   the edge taper and twice per Richardson-Lucy step)
//   MODE_CONV_CONJ  F = G * conj(H): the convolution with the mirrored
//                   PSF (H of a real PSF), RL's second conv. The JAX
//                   package passes -H_im instead; the flag saves a negated
//                   copy of the spectrum (17 MB at 2048^2) per RL step.
// The filter is the only difference between the modes: one template body
// compiles each, so the Wiener instance keeps the single-mode code. The
// conv modes move the same bytes as Wiener (A and H in, the result out)
// and so share its bound.
//
// In the transposed orientation the middle of the 2D restore works on
// each row on its own: per block of rows it runs the DIF stages (the
// second forward pass), the filter against the matching rows of the PSF
// spectrum, then the DIT stages (the first inverse pass), and writes the
// block transposed, ready for the final row IFFT. The filtered 2D
// spectrum never goes to device memory.
//
// What bounds it on the H100: it reads A (67 MB at 2048^2 x 2 planes)
// and H (34 MB) and writes the result (67 MB), about 50 us at 3.35 TB/s;
// its 2*log2(n) shared-memory butterfly stages cost more,
// so like fft_rows it is bound by shared-memory traffic and the barriers
// between stages. The design keeps each row block in shared memory from
// the first stage to the store, so the fusion saves two full device
// round trips of the spectrum (what the TPU kernel saves in VMEM).
//
// fwd_wiener_rows: column FFT -> Wiener -> natural write. Replaces
// wiener_spectral.py:fwd_wiener_rows_pallas ("fftr_fwd_wiener", B7), the
// middle the pipeline takes for short columns (hp < 512, e.g. a 256^2
// stack): B2's body without the DIT stages, so the filtered spectrum
// goes to device memory once and fft_rows' inverse pass with transposed
// store (csrc/fft_rows.cu) finishes the middle. Bound on the H100: it
// reads A and H and writes F, 101 MB for a batch of 64 256^2 frames (96
// pairs), about 30 us at 3.35 TB/s; its log2(n) shared-memory stages
// (8 at n=256) and their barriers are the likelier limit, as for
// fft_rows. The filter is applied as each element is stored, so the
// epilogue costs no extra pass over shared memory.
//
// wiener_spectral_rows: row DIF -> Wiener -> row DIT, natural store.
// Replaces wiener_spectral.py:wiener_spectral_rows_pallas (B10,
// "fftr_spectral_mid"), the untransposed fused middle the JAX A/B harness
// runs (tools/perf_ab.py megakernel): spectral_t_kernel<MODE_WIENER,
// false, true>, B2's body with each row block stored where it was read.
// H row m serves every plane's row m (the JAX wrapper materializes the
// broadcast H per plane; here it is indexed, never copied), and a ragged
// last row block is bounds-checked (JAX pads). Same bound as B2: A and H
// in, the result out, 168 MB at (2, 2048, 2048); shared-memory stages and
// barriers are the likelier limit.
//
// Grid of all three: one dimension, block b takes row block b % nblk of
// plane b / nblk (the plane count is not held to gridDim.y's 65535).
//
// Mixed radix (--pad smooth, B-mixed): at a smooth column length the
// MIXED instances run the forward cross levels before the DIF stages and
// (B2) the inverse ones after the DIT stages, each direction's levels in
// one shared-memory pass (fft_common.cuh cross_pass), from two CrossPlans
// passed by value beside the stage tables; the stages index the rows' R
// q-blocks with shifts; the filters and the stores are unchanged. grid_of's M / rows and the wrappers' row-block
// check hold at smooth M as at pow2 M.
#include "fft_common.cuh"

enum SpectralMode { MODE_WIENER = 0, MODE_CONV = 1, MODE_CONV_CONJ = 2 };

// NATURAL (B10, pow2 N, MODE_WIENER only): the block's rows are stored
// in place of the transposed write, and rows past M (a ragged last block)
// read as zero and are not stored; without it the code is B2's as it was.
template <int MODE, bool MIXED, bool NATURAL = false>
__global__ void __launch_bounds__(FFT_THREADS)
spectral_t_kernel(const float* __restrict__ a_re,
                  const float* __restrict__ a_im,
                  const float* __restrict__ h_re,
                  const float* __restrict__ h_im, float K,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  int M, int N, int stages, int rows, int nblk,
                  const float* __restrict__ cos_f,
                  const float* __restrict__ sin_f,
                  const float* __restrict__ cos_i,
                  const float* __restrict__ sin_i,
                  const __grid_constant__ CrossPlan plan_f,
                  const __grid_constant__ CrossPlan plan_i) {
  static_assert(!(NATURAL && MIXED), "the natural store takes pow2 rows only");
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + rows * N;
  const int p = blockIdx.x / nblk;
  const int m0 = (blockIdx.x - p * nblk) * rows;
  const int total = rows * N;
  const size_t base = ((size_t)p * M + m0) * N;
  const size_t hbase = (size_t)m0 * N;
  // the live elements of the block (all of them unless NATURAL's last block)
  const int live = NATURAL ? (M - m0 < rows ? M - m0 : rows) * N : total;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    if (NATURAL && t >= live) {
      sre[t] = 0.0f;
      sim[t] = 0.0f;
    } else {
      sre[t] = a_re[base + t];
      sim[t] = a_im[base + t];
    }
  }
  __syncthreads();
  if (MIXED) cross_pass_any<false>(sre, sim, rows, stages, plan_f);
  dif_stages(sre, sim, rows * (N >> stages), stages, N, cos_f, sin_f);

  for (int t = threadIdx.x; t < live; t += blockDim.x) {
    const float hr = h_re[hbase + t], hi = h_im[hbase + t];
    const float xr = sre[t], xi = sim[t];
    if (MODE == MODE_WIENER) {
      const float inv = 1.0f / (hr * hr + hi * hi + K);
      sre[t] = (xr * hr + xi * hi) * inv;
      sim[t] = (xi * hr - xr * hi) * inv;
    } else if (MODE == MODE_CONV) {
      sre[t] = xr * hr - xi * hi;
      sim[t] = xr * hi + xi * hr;
    } else {  // MODE_CONV_CONJ
      sre[t] = xr * hr + xi * hi;
      sim[t] = xi * hr - xr * hi;
    }
  }
  __syncthreads();
  dit_stages(sre, sim, rows * (N >> stages), stages, N, cos_i, sin_i);
  if (MIXED) cross_pass_any<true>(sre, sim, rows, stages, plan_i);

  if (NATURAL) {
    for (int t = threadIdx.x; t < live; t += blockDim.x) {
      out_re[base + t] = sre[t];
      out_im[base + t] = sim[t];
    }
  } else {
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
}

template <bool MIXED>
__global__ void __launch_bounds__(FFT_THREADS)
fwd_wiener_rows_kernel(const float* __restrict__ a_re,
                       const float* __restrict__ a_im,
                       const float* __restrict__ h_re,
                       const float* __restrict__ h_im, float K,
                       float* __restrict__ out_re, float* __restrict__ out_im,
                       int M, int N, int stages, int rows, int nblk,
                       const float* __restrict__ cos_f,
                       const float* __restrict__ sin_f,
                       const __grid_constant__ CrossPlan plan_f) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + rows * N;
  const int p = blockIdx.x / nblk;
  const int m0 = (blockIdx.x - p * nblk) * rows;
  const int total = rows * N;
  const size_t base = ((size_t)p * M + m0) * N;
  const size_t hbase = (size_t)m0 * N;

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    sre[t] = a_re[base + t];
    sim[t] = a_im[base + t];
  }
  __syncthreads();
  if (MIXED) cross_pass_any<false>(sre, sim, rows, stages, plan_f);
  dif_stages(sre, sim, rows * (N >> stages), stages, N, cos_f, sin_f);

  // F = G * conj(H) / (|H|^2 + K), stored in natural (P, M, N) order
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const float hr = h_re[hbase + t], hi = h_im[hbase + t];
    const float xr = sre[t], xi = sim[t];
    const float inv = 1.0f / (hr * hr + hi * hi + K);
    out_re[base + t] = (xr * hr + xi * hi) * inv;
    out_im[base + t] = (xi * hr - xr * hi) * inv;
  }
}

// grid of P planes x M / rows row blocks; 0 or a cudaError_t
static int grid_of(int P, int M, int rows, int* nblk, int* blocks) {
  *nblk = M / rows;
  if ((long long)*nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = *nblk * P;
  return 0;
}

template <int MODE, bool MIXED>
static int launch_spectral_t(const void* a_re, const void* a_im,
                             const void* h_re, const void* h_im, float K,
                             void* out_re, void* out_im, int P, int M, int N,
                             int stages, int rows, const void* cos_f,
                             const void* sin_f, const void* cos_i,
                             const void* sin_i, const CrossPlan& plan_f,
                             const CrossPlan& plan_i, void* stream) {
  const size_t smem = 2 * (size_t)rows * N * sizeof(float);
  cudaError_t err = allow_smem(spectral_t_kernel<MODE, MIXED>, smem);
  if (err != cudaSuccess) return (int)err;
  int nblk, blocks;
  if (int e = grid_of(P, M, rows, &nblk, &blocks)) return e;
  spectral_t_kernel<MODE, MIXED>
      <<<blocks, FFT_THREADS, smem, (cudaStream_t)stream>>>(
          (const float*)a_re, (const float*)a_im, (const float*)h_re,
          (const float*)h_im, K, (float*)out_re, (float*)out_im, M, N, stages,
          rows, nblk, (const float*)cos_f, (const float*)sin_f,
          (const float*)cos_i, (const float*)sin_i, plan_f, plan_i);
  return (int)cudaGetLastError();
}

// the two directions' cross levels (levels 0 for a pow2 N; see
// make_cross_plan), as the C entries receive them
#define CROSS_ARGS(d)                                                    \
  int levels_##d, const int *radix_##d, const float *coef_##d,           \
      const void *xcos_##d, const void *xsin_##d
#define CROSS_PLAN(d) \
  make_cross_plan(levels_##d, radix_##d, coef_##d, xcos_##d, xsin_##d)

template <int MODE>
static int launch_mode(const void* a_re, const void* a_im, const void* h_re,
                       const void* h_im, float K, void* out_re, void* out_im,
                       int P, int M, int N, int stages, int rows,
                       const void* cos_f, const void* sin_f, const void* cos_i,
                       const void* sin_i, const CrossPlan& plan_f,
                       const CrossPlan& plan_i, void* stream) {
  if (plan_f.levels != plan_i.levels || radix_code(plan_f) < 0 || radix_code(plan_i) < 0)
    return (int)cudaErrorInvalidValue;
  if (plan_f.levels > 0)
    return launch_spectral_t<MODE, true>(a_re, a_im, h_re, h_im, K, out_re,
                                         out_im, P, M, N, stages, rows, cos_f,
                                         sin_f, cos_i, sin_i, plan_f, plan_i,
                                         stream);
  return launch_spectral_t<MODE, false>(a_re, a_im, h_re, h_im, K, out_re,
                                        out_im, P, M, N, stages, rows, cos_f,
                                        sin_f, cos_i, sin_i, plan_f, plan_i,
                                        stream);
}

static bool bad_levels(int levels) {
  return levels < 0 || levels > MAX_CROSS_LEVELS;
}

extern "C" int wiener_spectral_t_launch(const void* a_re, const void* a_im,
                                        const void* h_re, const void* h_im,
                                        float K, void* out_re, void* out_im,
                                        int P, int M, int N, int stages,
                                        int rows, const void* cos_f,
                                        const void* sin_f, const void* cos_i,
                                        const void* sin_i, CROSS_ARGS(f),
                                        CROSS_ARGS(i), void* stream) {
  if (bad_levels(levels_f) || bad_levels(levels_i)) return (int)cudaErrorInvalidValue;
  return launch_mode<MODE_WIENER>(a_re, a_im, h_re, h_im, K, out_re, out_im, P,
                                  M, N, stages, rows, cos_f, sin_f, cos_i,
                                  sin_i, CROSS_PLAN(f), CROSS_PLAN(i), stream);
}

// conj != 0: F = G * conj(H) (the mirrored PSF's convolution)
extern "C" int spectral_conv_t_launch(const void* a_re, const void* a_im,
                                      const void* h_re, const void* h_im,
                                      int conj, void* out_re, void* out_im,
                                      int P, int M, int N, int stages,
                                      int rows, const void* cos_f,
                                      const void* sin_f, const void* cos_i,
                                      const void* sin_i, CROSS_ARGS(f),
                                      CROSS_ARGS(i), void* stream) {
  if (bad_levels(levels_f) || bad_levels(levels_i)) return (int)cudaErrorInvalidValue;
  const CrossPlan plan_f = CROSS_PLAN(f), plan_i = CROSS_PLAN(i);
  if (conj)
    return launch_mode<MODE_CONV_CONJ>(a_re, a_im, h_re, h_im, 0.0f, out_re,
                                       out_im, P, M, N, stages, rows, cos_f,
                                       sin_f, cos_i, sin_i, plan_f, plan_i,
                                       stream);
  return launch_mode<MODE_CONV>(a_re, a_im, h_re, h_im, 0.0f, out_re, out_im,
                                P, M, N, stages, rows, cos_f, sin_f, cos_i,
                                sin_i, plan_f, plan_i, stream);
}

template <bool MIXED>
static int launch_fwd_wiener(const void* a_re, const void* a_im,
                             const void* h_re, const void* h_im, float K,
                             void* out_re, void* out_im, int P, int M, int N,
                             int stages, int rows, const void* cos_f,
                             const void* sin_f, const CrossPlan& plan_f,
                             void* stream) {
  const size_t smem = 2 * (size_t)rows * N * sizeof(float);
  cudaError_t err = allow_smem(fwd_wiener_rows_kernel<MIXED>, smem);
  if (err != cudaSuccess) return (int)err;
  int nblk, blocks;
  if (int e = grid_of(P, M, rows, &nblk, &blocks)) return e;
  fwd_wiener_rows_kernel<MIXED>
      <<<blocks, FFT_THREADS, smem, (cudaStream_t)stream>>>(
          (const float*)a_re, (const float*)a_im, (const float*)h_re,
          (const float*)h_im, K, (float*)out_re, (float*)out_im, M, N, stages,
          rows, nblk, (const float*)cos_f, (const float*)sin_f, plan_f);
  return (int)cudaGetLastError();
}

extern "C" int fwd_wiener_rows_launch(const void* a_re, const void* a_im,
                                      const void* h_re, const void* h_im,
                                      float K, void* out_re, void* out_im,
                                      int P, int M, int N, int stages, int rows,
                                      const void* cos_f, const void* sin_f,
                                      CROSS_ARGS(f), void* stream) {
  if (bad_levels(levels_f)) return (int)cudaErrorInvalidValue;
  const CrossPlan plan_f = CROSS_PLAN(f);
  if (radix_code(plan_f) < 0) return (int)cudaErrorInvalidValue;
  if (plan_f.levels > 0)
    return launch_fwd_wiener<true>(a_re, a_im, h_re, h_im, K, out_re, out_im,
                                   P, M, N, stages, rows, cos_f, sin_f, plan_f,
                                   stream);
  return launch_fwd_wiener<false>(a_re, a_im, h_re, h_im, K, out_re, out_im, P,
                                  M, N, stages, rows, cos_f, sin_f, plan_f,
                                  stream);
}

// wiener_spectral_rows (B10): B2's Wiener body with the natural store,
// over P planes of M rows (M any, the last row block ragged), N = 2^stages,
// `rows` rows a block (a power of two up to 16; the wrapper checks the
// shared memory); H is (M, N), row m serving every plane's row m
extern "C" int wiener_spectral_rows_launch(const void* a_re, const void* a_im,
                                           const void* h_re, const void* h_im,
                                           float K, void* out_re, void* out_im,
                                           int P, int M, int N, int stages,
                                           int rows, const void* cos_f,
                                           const void* sin_f, const void* cos_i,
                                           const void* sin_i, void* stream) {
  if (rows < 1 || N != (1 << stages)) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)rows * N * sizeof(float);
  cudaError_t err = allow_smem(spectral_t_kernel<MODE_WIENER, false, true>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (M + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const CrossPlan none = {};
  spectral_t_kernel<MODE_WIENER, false, true>
      <<<nblk * P, FFT_THREADS, smem, (cudaStream_t)stream>>>(
          (const float*)a_re, (const float*)a_im, (const float*)h_re,
          (const float*)h_im, K, (float*)out_re, (float*)out_im, M, N, stages,
          rows, nblk, (const float*)cos_f, (const float*)sin_f,
          (const float*)cos_i, (const float*)sin_i, none, none);
  return (int)cudaGetLastError();
}
