// fft_rows_t: the row FFT with the transposed store, its radix-2 stages
// held in registers (B1).
//
// Replaces fft_restoration_tpu/ops/pallas/fft_kernel.py:
// _fft_rows_transposed ("fftr_rows_T_fwd"): (P, M, N) planes -> row FFT ->
// (P, N, M), forward (DIF, bit-reversed out) or inverse (DIT, bit-reversed
// in), unscaled, from uint8 (x / 255.0f in the load) or float32, at a pow2
// N or a smooth N = R * q (R = R0 * R1 of the odd radices, q = 2^S), with
// fft_rows_load.cuh's strided channel-pair loader and zero pad. Every
// transposed pass of the port runs here: the frame and stack passes, the
// PSF's real-input pass, the forward pass of each conv, and the inverse
// pass after B7 and in inverse/CLS.
//
// What bounds it on the H100: it moves each input byte and writes each
// output float once (80 MB for a 2048^2 uint8 frame's two pairs, 24 us at
// 3.35 TB/s). The shared-memory design before this one ran each of the
// log2(n) stages as a full pass through shared memory with a barrier, one
// thread per butterfly (11 passes at n = 2048), and read the transposed
// columns with a rows-way bank conflict: 4-8x its memory floor.
//
// The design:
// - Stage groups in registers. The wrapper (ops/kernels/fft_kernel.py
//   t_plan) cuts the S stages into groups of k <= 4 consecutive stages
//   (11 = 4 + 4 + 3). A thread holds 16 complex values: 2^(4-k) items of
//   a group, each the 2^k elements b = lo | hb << (s_lo + k) | j << s_lo,
//   j < 2^k, whose k stages' butterflies never leave the item. It runs
//   them in registers, DIF from the top group down, DIT from the bottom
//   group up, with the stage tables' twiddles (the same butterflies, in
//   the same order, as the JAX _run_stages), and writes the values back
//   to shared memory once: S stages cost ceil(S / 4) exchanges and
//   barriers, not S.
// - The forward pow2 pass loads its first group straight from device
//   memory (neighbouring threads on neighbouring columns), and a forward
//   pass of 4 rows a block or more stores its last group's registers
//   straight to the transposed output (neighbouring threads on
//   neighbouring rows of one column): at n = 2048, load + 3 groups + store
//   take 2 shared-memory exchanges. The forward mixed pass runs both
//   cross levels in registers as it loads (cross_item), the inverse
//   mixed pass as it stores. uint8 converts without the division's slow
//   path (fft_rows_load.cuh).
// - The bottom group (stages 0 .. k-1) is compiled apart: its twiddle
//   offsets are constants, shared by a thread's items.
// - Bank conflicts: each row is padded one word in 32, and per group the
//   wrapper picks the thread-to-item map (items along the row first, or
//   across rows first) and the row stride whose accesses it finds
//   conflict-free in Python (the transposed read of the passes that
//   store through shared memory too): at most 2 threads a bank (in one
//   group of the 2048- and 4096-point forward passes, for one), 4 in one
//   group at n = 16384 (tests/test_torch_fft_passes.py holds the limits).
// - The transposed store writes 32 contiguous bytes or more per output
//   column at n <= 2304 (8+ rows a block), 16 at 3840-4096; blocks past
//   the live rows store zeros and transform nothing, so the wrapper
//   allocates its output with torch.empty (the zero fill of the design
//   before cost 44 us of a UHD frame at --pad smooth on an H100, 82 at
//   pow2).
// - Registers: 16 complex values and their 16 shared addresses a thread;
//   512 threads and one ~132-155 KB block an SM, __launch_bounds__(512, 1)
//   leaves 128 registers a thread.
// Measured on an H100 80GB HBM3 at 700 W: a 2048^2 uint8 frame's two
// pairs in 0.09 ms (3.7x the memory floor, 0.46x the shared-memory
// design), the UHD frame's 3840-wide smooth rows in 0.32 ms: not bound
// by its bytes; with one block an SM, most likely by instruction
// throughput and latency.
#include "fft_common.cuh"
#include "fft_rows_load.cuh"

#define T_SLOTS 16
#define T_MAX_GROUPS 6
#define T_THREADS 512

// The radix-2 stage groups of one launch, DIF order (top bits first):
// group g covers stages s_lo[g] .. s_lo[g] + k[g] - 1; item `it` of the
// group lies at q-block bit field (it >> ub_shift) & (2^(S-k) - 1), row
// (it >> row_shift) & (rows - 1) and cross block it >> (S - k + log2 rows)
struct GroupPlan {
  int groups;
  int direct_store;  // forward: the last group stores its registers (row map)
  int s_lo[T_MAX_GROUPS];
  int k[T_MAX_GROUPS];
  int ub_shift[T_MAX_GROUPS];
  int row_shift[T_MAX_GROUPS];
};

// padded shared-memory column: one word in every 32 left empty
__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 5); }

// Shared pieces of a launch for the stage groups
struct TBlock {
  float* sre;
  float* sim;
  int rs_smem;  // padded row stride, floats
  int logq;     // S
  int lr;       // log2(rows)
  int ns;       // slot sets: rows * N / 16
  int tstride;  // width of the stage tables (N)
  const float* __restrict__ cosv;
  const float* __restrict__ sinv;
  float* __restrict__ out_re;  // the transposed output of this pair
  float* __restrict__ out_im;
  int M, m0;
};

// One stage group of width K: slot set g holds items g + jh * ns, jh <
// 2^(4-K), 2^K elements each. LOAD: the values come from device memory
// (the forward pow2 pass's first group), else from shared memory. STORE:
// they go to the transposed output (the forward pass's last group, its
// map row first: neighbouring threads write neighbouring rows of one
// output column), else back to shared memory. BOTTOM: the group of the
// shortest stages (s_lo = 0), whose twiddle offsets are then constants
// shared by a thread's items.
template <int K, bool DIT, bool LOAD, bool STORE, bool BOTTOM, typename T>
__device__ __forceinline__ void stage_group(const TBlock& tb, int s_lo_arg, int ub_shift,
                                            int row_shift, const PairLoad<T>& ld) {
  const int s_lo = BOTTOM ? 0 : s_lo_arg;
  constexpr int J = T_SLOTS >> K;
  constexpr int E = 1 << K;
  const int lq = tb.logq - K;
  const int ub_mask = (1 << lq) - 1, row_mask = (1 << tb.lr) - 1;
  const int lo_mask = (1 << s_lo) - 1;
  for (int g = threadIdx.x; g < tb.ns; g += blockDim.x) {
    float xr[T_SLOTS], xi[T_SLOTS];
    int a[T_SLOTS];
    int lo[J];
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      const int it = g + jh * tb.ns;
      const int ub = (it >> ub_shift) & ub_mask;
      const int r = (it >> row_shift) & row_mask;
      const int c = it >> (lq + tb.lr);
      lo[jh] = ub & lo_mask;
      const int base = (c << tb.logq) | lo[jh] | ((ub >> s_lo) << (s_lo + K));
      const auto row = ld.row(r);
#pragma unroll
      for (int jl = 0; jl < E; ++jl) {
        const int j = jh * E + jl;
        const int i = base | (jl << s_lo);
        const int sa = r * tb.rs_smem + pad_idx(i);
        // STORE: a[j] is the output offset of (row, column i), -1 past
        // the plane; else the shared-memory slot
        a[j] = !STORE ? sa : tb.m0 + r < tb.M ? i * tb.M + r : -1;
        if (LOAD) {
          const float2 v = ld.at(row, i);
          xr[j] = v.x;
          xi[j] = v.y;
        } else {
          xr[j] = tb.sre[sa];
          xi[j] = tb.sim[sa];
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < K; ++bb) {
      const int b = DIT ? bb : K - 1 - bb;  // stage s_lo + b, half 2^(s_lo+b)
      const float* wc = tb.cosv + (size_t)(s_lo + b) * tb.tstride;
      const float* ws = tb.sinv + (size_t)(s_lo + b) * tb.tstride;
#pragma unroll
      for (int jh = 0; jh < J; ++jh) {
#pragma unroll
        for (int jl = 0; jl < E; ++jl) {
          if (jl & (1 << b)) continue;
          const int j0 = jh * E + jl, j1 = j0 + (1 << b);
          // the butterfly's offset in its block: the item's low bits and
          // the element bits below b
          const int pos = lo[jh] + ((jl & ((1 << b) - 1)) << s_lo);
          const float c = __ldg(wc + pos), sn = __ldg(ws + pos);
          const float ar = xr[j0], ai = xi[j0], br = xr[j1], bi = xi[j1];
          if (DIT) {
            const float wr = c * br - sn * bi, wi = c * bi + sn * br;
            xr[j0] = ar + wr;
            xi[j0] = ai + wi;
            xr[j1] = ar - wr;
            xi[j1] = ai - wi;
          } else {
            const float dr = ar - br, di = ai - bi;
            xr[j0] = ar + br;
            xi[j0] = ai + bi;
            xr[j1] = c * dr - sn * di;
            xi[j1] = c * di + sn * dr;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < T_SLOTS; ++j) {
      if (STORE) {
        if (a[j] >= 0) {
          tb.out_re[a[j]] = xr[j];
          tb.out_im[a[j]] = xi[j];
        }
      } else {
        tb.sre[a[j]] = xr[j];
        tb.sim[a[j]] = xi[j];
      }
    }
  }
}

template <bool DIT, bool LOAD, bool STORE, typename T>
__device__ __forceinline__ void run_group(const TBlock& tb, const GroupPlan& gp, int g,
                                          const PairLoad<T>& ld) {
  const int s_lo = gp.s_lo[g], us = gp.ub_shift[g], rsh = gp.row_shift[g];
  if (s_lo == 0) {
    switch (gp.k[g]) {
      case 1: stage_group<1, DIT, LOAD, STORE, true, T>(tb, s_lo, us, rsh, ld); break;
      case 2: stage_group<2, DIT, LOAD, STORE, true, T>(tb, s_lo, us, rsh, ld); break;
      case 3: stage_group<3, DIT, LOAD, STORE, true, T>(tb, s_lo, us, rsh, ld); break;
      default: stage_group<4, DIT, LOAD, STORE, true, T>(tb, s_lo, us, rsh, ld); break;
    }
    return;
  }
  switch (gp.k[g]) {
    case 1: stage_group<1, DIT, LOAD, STORE, false, T>(tb, s_lo, us, rsh, ld); break;
    case 2: stage_group<2, DIT, LOAD, STORE, false, T>(tb, s_lo, us, rsh, ld); break;
    case 3: stage_group<3, DIT, LOAD, STORE, false, T>(tb, s_lo, us, rsh, ld); break;
    default: stage_group<4, DIT, LOAD, STORE, false, T>(tb, s_lo, us, rsh, ld); break;
  }
}

// a forward group: LOAD for the pow2 pass's first, STORE for the last
// when the plan stores from registers (a plan of two groups or more)
template <int R, typename T>
__device__ __forceinline__ void forward_group(const TBlock& tb, const GroupPlan& gp, int g,
                                              const PairLoad<T>& ld) {
  const bool store = gp.direct_store && g == gp.groups - 1;  // never g = 0
  if constexpr (R == 1) {
    if (g == 0) {
      run_group<false, true, false>(tb, gp, g, ld);
      return;
    }
  }
  if (store)
    run_group<false, false, true>(tb, gp, g, ld);
  else
    run_group<false, false, false>(tb, gp, g, ld);
}

// N = R0 * R1 * 2^logq; rows = 2^lr rows a block; rs_smem the padded row
// stride; block b takes rows m0 = (b % nblk) * rows of pair b / nblk
template <typename T, bool INV, int R0, int R1>
__global__ void __launch_bounds__(T_THREADS, 1)
fft_rows_t_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                  long long is, long long chs, int channels, int qstep, int qim,
                  long long rs, long long cs, int re_live, int im_live,
                  int live_rows, int live_cols, int M, int logq, int lr,
                  int rs_smem, int nblk, float* __restrict__ out_re,
                  float* __restrict__ out_im, const float* __restrict__ cosv,
                  const float* __restrict__ sinv,
                  const __grid_constant__ GroupPlan gp,
                  const __grid_constant__ CrossPlan cp) {
  constexpr int R = R0 * R1;
  extern __shared__ float smem[];
  const int rows = 1 << lr;
  const int q = 1 << logq;
  const int N = R * q;
  const int p = blockIdx.x / nblk;
  const int m0 = (blockIdx.x - p * nblk) * rows;
  const size_t obase = (size_t)p * N * M;
  const int total = rows * N;

  if (m0 >= live_rows) {  // rows past the live ones: zeros, no transform
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = t & (rows - 1), m = m0 + r;
      if (m < M) {
        const size_t o = obase + (size_t)(t >> lr) * M + m;
        out_re[o] = 0.0f;
        out_im[o] = 0.0f;
      }
    }
    return;
  }

  const TBlock tb = {smem, smem + rows * rs_smem, rs_smem, logq, lr, total >> 4,
                     N, cosv, sinv, out_re + obase + m0, out_im + obase + m0, M, m0};
  const PairLoad<T> ld(src_re, src_im, is, chs, channels, qstep, qim, rs, cs,
                       re_live, im_live, live_rows, live_cols, p, m0);

  if (!INV) {
    if (R > 1) {  // load + both cross levels, item (row, b): b fastest
      for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
        const int b = t & (q - 1), r = t >> logq;
        float xr[R], xi[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float2 v = ld.get(r, b + j * q);
          xr[j] = v.x;
          xi[j] = v.y;
        }
        cross_item<R0, R1, false>(xr, xi, b, q, N, cp);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int a = r * rs_smem + pad_idx(b + j * q);
          tb.sre[a] = xr[j];
          tb.sim[a] = xi[j];
        }
      }
      __syncthreads();
    }
    for (int g = 0; g < gp.groups; ++g) {
      forward_group<R>(tb, gp, g, ld);
      __syncthreads();
    }
    if (gp.direct_store) return;
  } else {
    // coalesced load: element (b + j*q) of row r, b fastest
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = (t >> logq) & (rows - 1);
      const int c = (t & (q - 1)) + ((t >> (logq + lr)) << logq);
      const int a = r * rs_smem + pad_idx(c);
      const float2 v = ld.get(r, c);
      tb.sre[a] = v.x;
      tb.sim[a] = v.y;
    }
    __syncthreads();
    for (int g = gp.groups - 1; g >= 0; --g) {
      run_group<true, false, false>(tb, gp, g, ld);
      __syncthreads();
    }
    if (R > 1) {  // both inverse cross levels, then the transposed store
      for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
        const int r = t & (rows - 1), b = t >> lr, m = m0 + r;
        float xr[R], xi[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int a = r * rs_smem + pad_idx(b + j * q);
          xr[j] = tb.sre[a];
          xi[j] = tb.sim[a];
        }
        cross_item<R0, R1, true>(xr, xi, b, q, N, cp);
        if (m < M) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const size_t o = obase + (size_t)(b + j * q) * M + m;
            out_re[o] = xr[j];
            out_im[o] = xi[j];
          }
        }
      }
      return;
    }
  }

  // (P, M, N) -> (P, N, M): neighbouring threads take neighbouring rows of
  // one column
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t & (rows - 1), k = t >> lr, m = m0 + r;
    if (m < M) {
      const int a = r * rs_smem + pad_idx(k);
      const size_t o = obase + (size_t)k * M + m;
      out_re[o] = tb.sre[a];
      out_im[o] = tb.sim[a];
    }
  }
}

template <typename T, bool INV, int R0, int R1>
static int launch_t(const void* src_re, const void* src_im, long long is,
                    long long chs, int channels, int qstep, int qim, long long rs,
                    long long cs, int re_live, int im_live, int live_rows,
                    int live_cols, int P, int M, int logq, int lr, int rs_smem,
                    int threads, void* out_re, void* out_im, const void* cosv,
                    const void* sinv, const GroupPlan& gp, const CrossPlan& cp,
                    cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
  cudaError_t err = allow_smem(fft_rows_t_kernel<T, INV, R0, R1>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 1 << lr;
  const int nblk = (M + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fft_rows_t_kernel<T, INV, R0, R1><<<nblk * P, threads, smem, stream>>>(
      (const T*)src_re, (const T*)src_im, is, chs, channels, qstep, qim, rs, cs,
      re_live, im_live, live_rows, live_cols, M, logq, lr, rs_smem, nblk,
      (float*)out_re, (float*)out_im, (const float*)cosv, (const float*)sinv, gp, cp);
  return (int)cudaGetLastError();
}

template <typename T, bool INV>
static int launch_radices(int code, const void* src_re, const void* src_im,
                          long long is, long long chs, int channels, int qstep,
                          int qim, long long rs, long long cs, int re_live,
                          int im_live, int live_rows, int live_cols, int P, int M,
                          int logq, int lr, int rs_smem, int threads, void* out_re,
                          void* out_im, const void* cosv, const void* sinv,
                          const GroupPlan& gp, const CrossPlan& cp,
                          cudaStream_t stream) {
#define FFT_ROWS_T_LAUNCH(R0, R1)                                                   \
  launch_t<T, INV, R0, R1>(src_re, src_im, is, chs, channels, qstep, qim, rs, cs, \
                           re_live, im_live, live_rows, live_cols, P, M, logq, lr, \
                           rs_smem, threads, out_re, out_im, cosv, sinv, gp, cp,   \
                           stream)
  switch (code) {
    case 0: return FFT_ROWS_T_LAUNCH(1, 1);
    case 1: return FFT_ROWS_T_LAUNCH(3, 1);
    case 2: return FFT_ROWS_T_LAUNCH(5, 1);
    case 3: return FFT_ROWS_T_LAUNCH(3, 3);
    case 4: return FFT_ROWS_T_LAUNCH(3, 5);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFT_ROWS_T_LAUNCH
}

// plan: groups, direct store, then per group s_lo, k, ub_shift,
// row_shift (the wrapper's t_plan); logq = S; lr = log2(rows); rs_smem the padded row stride;
// threads a multiple of 32 up to 512; levels .. xsin: the cross levels of
// this direction (levels 0 for a pow2 N; see make_cross_plan)
extern "C" int fft_rows_t_launch(const void* src_re, const void* src_im, int in_u8,
                                 long long is, long long chs, int channels, int qstep,
                                 int qim, long long rs, long long cs, int re_live,
                                 int im_live, int live_rows, int live_cols, int P,
                                 int M, int logq, int lr, int rs_smem, int threads,
                                 void* out_re, void* out_im, int inverse,
                                 const void* cosv, const void* sinv, const int* plan,
                                 int levels, const int* radix, const float* coef,
                                 const void* xcos, const void* xsin, void* stream) {
  if (levels < 0 || levels > MAX_CROSS_LEVELS || plan[0] < 1 || plan[0] > T_MAX_GROUPS ||
      threads < 32 || threads > T_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  GroupPlan gp = {};
  gp.groups = plan[0];
  gp.direct_store = plan[1] && !inverse && gp.groups > 1;
  int stages = 0;
  for (int g = 0; g < gp.groups; ++g) {
    gp.s_lo[g] = plan[2 + 4 * g];
    gp.k[g] = plan[3 + 4 * g];
    gp.ub_shift[g] = plan[4 + 4 * g];
    gp.row_shift[g] = plan[5 + 4 * g];
    if (gp.k[g] < 1 || gp.k[g] > 4) return (int)cudaErrorInvalidValue;
    stages += gp.k[g];
  }
  // 16 slots a thread: every slot set full (rows * q >= 16)
  if (stages != logq || logq + lr < 4) return (int)cudaErrorInvalidValue;
  const CrossPlan cp = make_cross_plan(levels, radix, coef, xcos, xsin);
  const int code = radix_code(cp);
  cudaStream_t st = (cudaStream_t)stream;
#define FFT_ROWS_T_ARGS                                                              \
  code, src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live,     \
      live_rows, live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, cosv, \
      sinv, gp, cp, st
  if (in_u8)
    return inverse ? launch_radices<uint8_t, true>(FFT_ROWS_T_ARGS)
                   : launch_radices<uint8_t, false>(FFT_ROWS_T_ARGS);
  return inverse ? launch_radices<float, true>(FFT_ROWS_T_ARGS)
                 : launch_radices<float, false>(FFT_ROWS_T_ARGS);
#undef FFT_ROWS_T_ARGS
}
