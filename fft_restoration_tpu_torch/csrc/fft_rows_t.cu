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
// - Stage groups in registers, from the engine shared with B3/B6
//   (fft_groups.cuh: GroupPlan, TBlock, stage_group, run_group). The
//   wrapper (ops/kernels/fft_kernel.py t_plan) cuts the S stages into
//   groups of k <= 4 consecutive stages (11 = 4 + 4 + 3); a thread holds
//   16 complex values, 2^(4-k) items of 2^k elements a group, runs the
//   group's butterflies in registers (the JAX _run_stages' butterflies in
//   their order) and writes the values back to shared memory once: S
//   stages cost ceil(S / 4) exchanges and barriers, not S.
// - The forward pow2 pass loads its first group straight from device
//   memory (neighbouring threads on neighbouring columns), and a forward
//   pass of 4 rows a block or more stores its last group's registers
//   straight to the transposed output (neighbouring threads on
//   neighbouring rows of one column): at n = 2048, load + 3 groups + store
//   take 2 shared-memory exchanges. The forward mixed pass runs both
//   cross levels in registers as it loads (cross_item), the inverse
//   mixed pass as it stores. uint8 converts without the division's slow
//   path (fft_rows_load.cuh).
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
//
// The MXU engine (engine="mxu", the JAX package's default):
// fft_rows_t_mxu_kernel<T, O, INV, R0, R1, ENG> runs the plan's groups
// over the outer stages 7 .. logq - 1 and the tensor-core group DFT in
// place of the inner 7 (forward last, inverse first), the transposed read
// of the shared rows storing every pass. Its group DFT is
// fft_group_dft_smem.cuh's: the tables resident in shared memory (one
// bulk copy a block), one persistent block an SM walking over the row
// blocks (t_plan(mxu=True): 8 rows of 2048 points, so that the
// transposed store writes 32-byte column segments, beside 62 of the 64
// 'default' table chunks or all of the 'highest' ones), the rows loaded
// as 16-byte vectors (inverse passes) and the transposed store writing 4
// rows of a column a thread (4-row blocks, whose 16-byte segments half
// fill a sector, took an H100 1.7x as long). The design before (the L2
// design: group_dft reading the tables through L1 and L2 for every 8 groups, 8
// rows a block) took 0.1165 ms ('default') / 0.3641 ms ('highest') for
// those pairs, against torch.fft's 0.053. The forward passes at 'default'
// keep it, fft_rows_t_l2_kernel (fft_rows_t_body at ENG_BF16), which an
// H100 runs 6-14% faster than the resident design there: beside 8 rows
// the tables' L1 hits cost what shared loads do.
// fft_rows_t_kernel keeps its parameters and its code: the roll
// instances' machine code is the one before (tools/kernel_ab.py --sass).
//
// bf16 staging (stage_dtype="bf16", the JAX out_dtype=bfloat16 of
// _fft_rows_transposed): the forward pass at either engine, its transposed
// store rounding to bfloat16 (round to nearest even): half the bytes
// written, and half the next kernel's reads: fft_rows_t_bf16_kernel at
// roll, fft_rows_t_l2_kernel<T, __nv_bfloat16, ..> at mxu 'default',
// fft_rows_t_mxu_kernel<T, __nv_bfloat16, ..> at 'highest'. Their
// instances build in translation units of their own (FFT_STAGE_TU, one an
// engine: ops/kernels/_build.py STAGE_UNITS), so every float32 instance
// keeps its machine code.
#include "fft_group_dft_smem.cuh"

#define T_THREADS 512

// a forward group: LD_ROW for the pow2 pass's first, ST_T for the last
// when the plan stores from registers (a plan of two groups or more)
template <int R, typename T, typename O>
__device__ __forceinline__ void forward_group(const TBlockOf<O>& tb, const GroupPlan& gp, int g,
                                              const PairLoad<T>& ld) {
  float mm[4] = {};  // no min/max in this kernel
  const bool store = gp.direct_store && g == gp.groups - 1;  // never g = 0
  if constexpr (R == 1) {
    if (g == 0) {
      run_group<false, LD_ROW, ST_SMEM>(tb, gp, g, ld, false, mm);
      return;
    }
  }
  if (store)
    run_group<false, LD_SMEM, ST_T>(tb, gp, g, ld, false, mm);
  else
    run_group<false, LD_SMEM, ST_SMEM>(tb, gp, g, ld, false, mm);
}

// N = R0 * R1 * 2^logq; rows = 2^lr rows a block; rs_smem the padded row
// stride; block b takes rows m0 = (b % nblk) * rows of pair b / nblk.
// ENG (fft_group_dft.cuh): ENG_ROLL runs the plan's radix-2 groups over
// all logq stages; a tensor-core engine runs them over the outer stages 7
// .. logq - 1 and the group DFT (tables dft) in place of the inner 7,
// forward after the outer groups, inverse before them, with no direct
// store (the transposed read of the shared rows stores every pass).
// O: the output's element type (float32; bfloat16 for bf16 staging).
template <typename T, typename O, bool INV, int R0, int R1, int ENG>
__device__ __forceinline__ void fft_rows_t_body(
    const T* __restrict__ src_re, const T* __restrict__ src_im, long long is, long long chs,
    int channels, int qstep, int qim, long long rs, long long cs, int re_live, int im_live,
    int live_rows, int live_cols, int M, int logq, int lr, int rs_smem, int nblk,
    O* __restrict__ out_re, O* __restrict__ out_im, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const GroupPlan& gp, const CrossPlan& cp,
    const void* __restrict__ dft) {
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
        out_re[o] = to_out<O>(0.0f);
        out_im[o] = to_out<O>(0.0f);
      }
    }
    return;
  }

  const TBlockOf<O> tb = {smem, smem + rows * rs_smem, rs_smem, logq, lr, total >> 4,
                         N, cosv, sinv, out_re + obase + m0, out_im + obase + m0, M, m0};
  const PairLoad<T> ld(src_re, src_im, is, chs, channels, qstep, qim, rs, cs,
                       re_live, im_live, live_rows, live_cols, p, m0);

  if (!INV) {
    if constexpr (R == 1 && ENG != ENG_ROLL) {
      if (gp.groups == 0) {  // q = 128: the group DFT alone, from the shared rows
        for (int t = threadIdx.x; t < total; t += blockDim.x) {
          const int r = t >> logq, c = t & (q - 1);
          const float2 v = ld.get(r, c);
          tb.sre[r * rs_smem + pad_idx(c)] = v.x;
          tb.sim[r * rs_smem + pad_idx(c)] = v.y;
        }
        __syncthreads();
      }
    }
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
    if constexpr (ENG != ENG_ROLL) {
      group_dft<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, dft,
                     SmemEpi{tb.sre, tb.sim, rs_smem});
      __syncthreads();
    } else if (gp.direct_store) {
      return;
    }
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
    if constexpr (ENG != ENG_ROLL) {
      group_dft<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, dft,
                     SmemEpi{tb.sre, tb.sim, rs_smem});
      __syncthreads();
    }
    float mm[4] = {};  // no min/max in this kernel
    for (int g = gp.groups - 1; g >= 0; --g) {
      run_group<true, LD_SMEM, ST_SMEM>(tb, gp, g, ld, false, mm);
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
            out_re[o] = to_out<O>(xr[j]);
            out_im[o] = to_out<O>(xi[j]);
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
      out_re[o] = to_out<O>(tb.sre[a]);
      out_im[o] = to_out<O>(tb.sim[a]);
    }
  }
}

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
  fft_rows_t_body<T, float, INV, R0, R1, ENG_ROLL>(src_re, src_im, is, chs, channels, qstep, qim, rs,
                                            cs, re_live, im_live, live_rows, live_cols, M,
                                            logq, lr, rs_smem, nblk, out_re, out_im, cosv,
                                            sinv, gp, cp, nullptr);
}

// bf16 staging at roll: the forward pass storing bfloat16 planes
template <typename T, int R0, int R1>
__global__ void __launch_bounds__(T_THREADS, 1)
fft_rows_t_bf16_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                       long long is, long long chs, int channels, int qstep, int qim,
                       long long rs, long long cs, int re_live, int im_live,
                       int live_rows, int live_cols, int M, int logq, int lr,
                       int rs_smem, int nblk, __nv_bfloat16* __restrict__ out_re,
                       __nv_bfloat16* __restrict__ out_im, const float* __restrict__ cosv,
                       const float* __restrict__ sinv,
                       const __grid_constant__ GroupPlan gp,
                       const __grid_constant__ CrossPlan cp) {
  fft_rows_t_body<T, __nv_bfloat16, false, R0, R1, ENG_ROLL>(
      src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
      live_cols, M, logq, lr, rs_smem, nblk, out_re, out_im, cosv, sinv, gp, cp, nullptr);
}

// The forward passes at 'default': the L2 design's MXU instance,
// fft_rows_t_body at ENG_BF16 (group_dft reading its tables through L1 and L2, one block
// of t_plan(mxu=True, resident=False)'s rows a row block), which an H100
// runs 6-14% faster than the resident design's forward pass (the
// tables' L1 hits cost what shared loads do, and the resident copy's 93
// KB leave the L1 28 KB); O float32, or bfloat16 for bf16 staging
template <typename T, typename O, int R0, int R1>
__global__ void __launch_bounds__(T_THREADS, 1)
fft_rows_t_l2_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                     long long is, long long chs, int channels, int qstep, int qim,
                     long long rs, long long cs, int re_live, int im_live,
                     int live_rows, int live_cols, int M, int logq, int lr,
                     int rs_smem, int nblk, O* __restrict__ out_re,
                     O* __restrict__ out_im, const float* __restrict__ cosv,
                     const float* __restrict__ sinv,
                     const __grid_constant__ GroupPlan gp,
                     const __grid_constant__ CrossPlan cp, const void* __restrict__ dft) {
  fft_rows_t_body<T, O, false, R0, R1, ENG_BF16>(
      src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
      live_cols, M, logq, lr, rs_smem, nblk, out_re, out_im, cosv, sinv, gp, cp, dft);
}

// four consecutive outputs from registers: one 16-byte float32 store, or
// one 8-byte store of four bfloat16 (each rounded to nearest even)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

// The MXU instances' transposed store of the block's shared rows, (P, M,
// N) -> (P, N, M): 4 rows of one column a thread, one vector store,
// neighbouring threads on neighbouring row quads, then columns (the
// shared reads conflict-free at t_plan's stride), where the rows come in
// quads and M is a multiple of 4; else a row a thread
template <typename O>
__device__ __forceinline__ void store_t_rows(const TBlockOf<O>& tb, O* __restrict__ out_re,
                                             O* __restrict__ out_im, size_t obase, int N) {
  const int lr = tb.lr, rows = 1 << lr, rs = tb.rs_smem, M = tb.M, m0 = tb.m0;
  if (rows >= 4 && (M & 3) == 0) {
    const int lq = lr - 2;
    for (int t = threadIdx.x; t < N << lq; t += blockDim.x) {
      const int r = (t & ((1 << lq) - 1)) << 2, k = t >> lq;
      if (m0 + r >= M) continue;
      const int a = r * rs + pad_idx(k);
      float vr[4], vi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vr[i] = tb.sre[a + i * rs];
        vi[i] = tb.sim[a + i * rs];
      }
      const size_t o = obase + (size_t)k * M + m0 + r;
      store4(out_re + o, vr);
      store4(out_im + o, vi);
    }
    return;
  }
  for (int t = threadIdx.x; t < rows * N; t += blockDim.x) {
    const int r = t & (rows - 1), k = t >> lr, m = m0 + r;
    if (m < M) {
      const int a = r * rs + pad_idx(k);
      const size_t o = obase + (size_t)k * M + m;
      out_re[o] = to_out<O>(tb.sre[a]);
      out_im[o] = to_out<O>(tb.sim[a]);
    }
  }
}

// The MXU engine's pass (ENG_BF16 or ENG_TF32X3; the parameters as
// fft_rows_t_body's): a persistent block walks over the `blocks` row
// blocks (block b as fft_rows_t_body's block b), the plan's groups
// running the outer stages 7 .. logq - 1 and the group DFT
// (fft_group_dft_smem.cuh; dft the direction's tables, their first
// tab_chunks chunks copied into the front of the block's shared memory as
// it starts, the rest read from dft) the inner 7:
// forward after the outer groups, inverse before them; the transposed
// read of the shared rows stores every pass
template <typename T, typename O, bool INV, int R0, int R1, int ENG>
__device__ __forceinline__ void fft_rows_t_mxu_body(
    const T* __restrict__ src_re, const T* __restrict__ src_im, long long is, long long chs,
    int channels, int qstep, int qim, long long rs, long long cs, int re_live, int im_live,
    int live_rows, int live_cols, int M, int logq, int lr, int rs_smem, int nblk, int blocks,
    O* __restrict__ out_re, O* __restrict__ out_im, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const GroupPlan& gp, const CrossPlan& cp,
    const void* __restrict__ dft, int tab_chunks) {
  constexpr int R = R0 * R1;
  // the tables' first tab_chunks chunks in front of the shared rows
  extern __shared__ __align__(16) unsigned char t_smem[];
  const int tab_bytes = tab_chunks * dft_res_chunk_bytes(ENG);
  uint64_t* bar = reinterpret_cast<uint64_t*>(t_smem + tab_bytes);
  float* srows = reinterpret_cast<float*>(t_smem + tab_bytes + DFT_RES_BAR);
  if (tab_bytes) dft_tables_start(t_smem, dft, tab_bytes, bar);
  const int rows = 1 << lr;
  const int q = 1 << logq;
  const int N = R * q;
  const int total = rows * N;
  for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int p = blk / nblk;
    const int m0 = (blk - p * nblk) * rows;
    const size_t obase = (size_t)p * N * M;
    if (m0 >= live_rows) {  // rows past the live ones: zeros, no transform
      for (int t = threadIdx.x; t < total; t += blockDim.x) {
        const int r = t & (rows - 1), m = m0 + r;
        if (m < M) {
          const size_t o = obase + (size_t)(t >> lr) * M + m;
          out_re[o] = to_out<O>(0.0f);
          out_im[o] = to_out<O>(0.0f);
        }
      }
      continue;
    }
    const TBlockOf<O> tb = {srows, srows + rows * rs_smem, rs_smem, logq, lr, total >> 4,
                            N, cosv, sinv, out_re + obase + m0, out_im + obase + m0, M, m0};
    const PairLoad<T> ld(src_re, src_im, is, chs, channels, qstep, qim, rs, cs,
                         re_live, im_live, live_rows, live_cols, p, m0);
    const SmemEpi epi{tb.sre, tb.sim, rs_smem};
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
      } else if (gp.groups == 0) {  // q = 128: the group DFT alone
        // element by element: rows_to_smem's vectors in flight here cost the
        // forward pass registers it spills everywhere (rows of 128 points)
        for (int t = threadIdx.x; t < total; t += blockDim.x) {
          const int r = t >> logq, c = t & (q - 1);
          const float2 v = ld.get(r, c);
          tb.sre[r * rs_smem + pad_idx(c)] = v.x;
          tb.sim[r * rs_smem + pad_idx(c)] = v.y;
        }
        __syncthreads();
      }
      for (int g = 0; g < gp.groups; ++g) {
        forward_group<R>(tb, gp, g, ld);
        __syncthreads();
      }
      if (tab_bytes) dft_tables_wait(bar);
      group_dft_res<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, t_smem, tab_chunks,
                         dft, epi);
      __syncthreads();
      store_t_rows(tb, out_re, out_im, obase, N);
    } else {
      rows_to_smem(tb, ld, rows, N);
      __syncthreads();
      if (tab_bytes) dft_tables_wait(bar);
      group_dft_res<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, t_smem, tab_chunks,
                         dft, epi);
      __syncthreads();
      float mm[4] = {};  // no min/max in this kernel
      for (int g = gp.groups - 1; g >= 0; --g) {
        run_group<true, LD_SMEM, ST_SMEM>(tb, gp, g, ld, false, mm);
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
              out_re[o] = to_out<O>(xr[j]);
              out_im[o] = to_out<O>(xi[j]);
            }
          }
        }
      } else {
        store_t_rows(tb, out_re, out_im, obase, N);
      }
    }
    __syncthreads();  // the shared rows read before the next row block lands
  }
  // no block leaves with the copy in flight: thread 0, which started it,
  // waits (the others may not have met a barrier since its mbarrier.init)
  if (tab_bytes && threadIdx.x == 0) dft_tables_wait(bar);
}

// the MXU engine's instances (ENG_BF16 or ENG_TF32X3): O float32, or
// bfloat16 for bf16 staging's forward pass; blocks = nblk * P row blocks
template <typename T, typename O, bool INV, int R0, int R1, int ENG>
__global__ void __launch_bounds__(T_THREADS, 1)
fft_rows_t_mxu_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                      long long is, long long chs, int channels, int qstep, int qim,
                      long long rs, long long cs, int re_live, int im_live,
                      int live_rows, int live_cols, int M, int logq, int lr,
                      int rs_smem, int nblk, int blocks, O* __restrict__ out_re,
                      O* __restrict__ out_im, const float* __restrict__ cosv,
                      const float* __restrict__ sinv,
                      const __grid_constant__ GroupPlan gp,
                      const __grid_constant__ CrossPlan cp, const void* __restrict__ dft,
                      int tab_chunks) {
  fft_rows_t_mxu_body<T, O, INV, R0, R1, ENG>(
      src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
      live_cols, M, logq, lr, rs_smem, nblk, blocks, out_re, out_im, cosv, sinv, gp, cp, dft,
      tab_chunks);
}

// the arguments of one launch, as the C entry passes them on
#define FFT_ROWS_T_LAUNCH_PARAMS                                                      \
  const void *src_re, const void *src_im, long long is, long long chs, int channels, \
      int qstep, int qim, long long rs, long long cs, int re_live, int im_live,      \
      int live_rows, int live_cols, int P, int M, int logq, int lr, int rs_smem,     \
      int threads, void *out_re, void *out_im, const void *cosv, const void *sinv,   \
      const GroupPlan &gp, const CrossPlan &cp, const DftRes &dft, cudaStream_t stream
#define FFT_ROWS_T_KERNEL_ARGS                                                           \
  nblk * P, threads, smem, stream, (const T*)src_re, (const T*)src_im, is, chs, channels, \
      qstep, qim, rs, cs, re_live, im_live, live_rows, live_cols, M, logq, lr, rs_smem,   \
      nblk, (float*)out_re, (float*)out_im, (const float*)cosv, (const float*)sinv, gp, cp

// The launch of an MXU instance (ENG_BF16 or ENG_TF32X3). Its instances
// are built in translation units of their own, in parallel with this one:
// this source compiled again with FFT_MXU_TU set to the engine
// (ops/kernels/_build.py MXU_UNITS).
template <typename T, bool INV, int R0, int R1, int ENG>
int launch_t_mxu(FFT_ROWS_T_LAUNCH_PARAMS);
// the launch of a bf16-staging instance, built in the FFT_STAGE_TU units
template <typename T, int R0, int R1, int ENG>
int launch_t_bf16(FFT_ROWS_T_LAUNCH_PARAMS);

// fft_rows_t_mxu_kernel's launch: dft.chunks of the tables in front of
// the rows, at most one persistent block a slot of the card
template <typename T, typename O, bool INV, int R0, int R1, int ENG>
int launch_t_res(FFT_ROWS_T_LAUNCH_PARAMS) {
  const long long smem = dft_res_smem<ENG>(dft, 2 * sizeof(float) * ((size_t)rs_smem << lr));
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const int rows = 1 << lr;
  const int nblk = (M + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return start_persistent(fft_rows_t_mxu_kernel<T, O, INV, R0, R1, ENG>, nblk * P, threads,
                          (size_t)smem, stream, (const T*)src_re, (const T*)src_im, is, chs,
                          channels, qstep, qim, rs, cs, re_live, im_live, live_rows, live_cols,
                          M, logq, lr, rs_smem, nblk, nblk * P, (O*)out_re, (O*)out_im,
                          (const float*)cosv, (const float*)sinv, gp, cp, dft.tab, dft.chunks);
}

// fft_rows_t_l2_kernel's launch (no table chunks: dft.chunks 0), one
// block a row block
template <typename T, typename O, int R0, int R1>
int launch_t_l2(FFT_ROWS_T_LAUNCH_PARAMS) {
  if (dft.tab == nullptr || dft.chunks != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
  const int rows = 1 << lr;
  const int nblk = (M + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return start_kernel(fft_rows_t_l2_kernel<T, O, R0, R1>, nblk * P, threads, smem, stream,
                      (const T*)src_re, (const T*)src_im, is, chs, channels, qstep, qim, rs,
                      cs, re_live, im_live, live_rows, live_cols, M, logq, lr, rs_smem, nblk,
                      (O*)out_re, (O*)out_im, (const float*)cosv, (const float*)sinv, gp, cp,
                      dft.tab);
}

#if defined(FFT_STAGE_TU)
template <typename T, int R0, int R1, int ENG>
int launch_t_bf16(FFT_ROWS_T_LAUNCH_PARAMS) {
  if constexpr (ENG == ENG_BF16) {
    return launch_t_l2<T, __nv_bfloat16, R0, R1>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, cosv, sinv, gp, cp, dft,
        stream);
  } else if constexpr (ENG != ENG_ROLL) {
    return launch_t_res<T, __nv_bfloat16, false, R0, R1, ENG>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, cosv, sinv, gp, cp, dft,
        stream);
  } else {
    const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
    const int rows = 1 << lr;
    const int nblk = (M + rows - 1) / rows;
    if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    return start_kernel(fft_rows_t_bf16_kernel<T, R0, R1>, nblk * P, threads, smem, stream,
                        (const T*)src_re, (const T*)src_im, is, chs, channels, qstep, qim, rs,
                        cs, re_live, im_live, live_rows, live_cols, M, logq, lr, rs_smem, nblk,
                        (__nv_bfloat16*)out_re, (__nv_bfloat16*)out_im, (const float*)cosv,
                        (const float*)sinv, gp, cp);
  }
}

#define FFT_ROWS_T_BF16(T)                                                              \
  template int launch_t_bf16<T, 1, 1, FFT_STAGE_TU>(FFT_ROWS_T_LAUNCH_PARAMS);         \
  template int launch_t_bf16<T, 3, 1, FFT_STAGE_TU>(FFT_ROWS_T_LAUNCH_PARAMS);         \
  template int launch_t_bf16<T, 5, 1, FFT_STAGE_TU>(FFT_ROWS_T_LAUNCH_PARAMS);         \
  template int launch_t_bf16<T, 3, 3, FFT_STAGE_TU>(FFT_ROWS_T_LAUNCH_PARAMS);         \
  template int launch_t_bf16<T, 3, 5, FFT_STAGE_TU>(FFT_ROWS_T_LAUNCH_PARAMS);
FFT_ROWS_T_BF16(float)
FFT_ROWS_T_BF16(uint8_t)
#undef FFT_ROWS_T_BF16
#elif defined(FFT_MXU_TU)
template <typename T, bool INV, int R0, int R1, int ENG>
int launch_t_mxu(FFT_ROWS_T_LAUNCH_PARAMS) {
  if constexpr (ENG == ENG_BF16 && !INV)
    return launch_t_l2<T, float, R0, R1>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, cosv, sinv, gp, cp, dft,
        stream);
  else
    return launch_t_res<T, float, INV, R0, R1, ENG>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, cosv, sinv, gp, cp, dft,
        stream);
}

#define FFT_ROWS_T_MXU(T, INV)                                                          \
  template int launch_t_mxu<T, INV, 1, 1, FFT_MXU_TU>(FFT_ROWS_T_LAUNCH_PARAMS);       \
  template int launch_t_mxu<T, INV, 3, 1, FFT_MXU_TU>(FFT_ROWS_T_LAUNCH_PARAMS);       \
  template int launch_t_mxu<T, INV, 5, 1, FFT_MXU_TU>(FFT_ROWS_T_LAUNCH_PARAMS);       \
  template int launch_t_mxu<T, INV, 3, 3, FFT_MXU_TU>(FFT_ROWS_T_LAUNCH_PARAMS);       \
  template int launch_t_mxu<T, INV, 3, 5, FFT_MXU_TU>(FFT_ROWS_T_LAUNCH_PARAMS);
FFT_ROWS_T_MXU(float, false)
FFT_ROWS_T_MXU(float, true)
FFT_ROWS_T_MXU(uint8_t, false)
FFT_ROWS_T_MXU(uint8_t, true)
#undef FFT_ROWS_T_MXU
#else

template <typename T, bool INV, int R0, int R1>
static int launch_t(const void* src_re, const void* src_im, long long is,
                    long long chs, int channels, int qstep, int qim, long long rs,
                    long long cs, int re_live, int im_live, int live_rows,
                    int live_cols, int P, int M, int logq, int lr, int rs_smem,
                    int threads, void* out_re, void* out_im, int out_bf16, const void* cosv,
                    const void* sinv, const GroupPlan& gp, const CrossPlan& cp,
                    int eng, const DftRes& dft, cudaStream_t stream) {
#define FFT_ROWS_T_MXU_ARGS                                                            \
  src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows, \
      live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, cosv, sinv, gp, cp, dft, stream
  if (out_bf16) {  // bf16 staging: forward passes only
    if constexpr (INV) {
      return (int)cudaErrorInvalidValue;
    } else {
      switch (eng) {
        case ENG_ROLL: return launch_t_bf16<T, R0, R1, ENG_ROLL>(FFT_ROWS_T_MXU_ARGS);
        case ENG_BF16: return launch_t_bf16<T, R0, R1, ENG_BF16>(FFT_ROWS_T_MXU_ARGS);
        case ENG_TF32X3: return launch_t_bf16<T, R0, R1, ENG_TF32X3>(FFT_ROWS_T_MXU_ARGS);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  switch (eng) {
    case ENG_ROLL: {
      const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
      const int rows = 1 << lr;
      const int nblk = (M + rows - 1) / rows;
      if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
      return start_kernel(fft_rows_t_kernel<T, INV, R0, R1>, FFT_ROWS_T_KERNEL_ARGS);
    }
    case ENG_BF16: return launch_t_mxu<T, INV, R0, R1, ENG_BF16>(FFT_ROWS_T_MXU_ARGS);
    case ENG_TF32X3: return launch_t_mxu<T, INV, R0, R1, ENG_TF32X3>(FFT_ROWS_T_MXU_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFT_ROWS_T_MXU_ARGS
}

template <typename T, bool INV>
static int launch_radices(int code, const void* src_re, const void* src_im,
                          long long is, long long chs, int channels, int qstep,
                          int qim, long long rs, long long cs, int re_live,
                          int im_live, int live_rows, int live_cols, int P, int M,
                          int logq, int lr, int rs_smem, int threads, void* out_re,
                          void* out_im, int out_bf16, const void* cosv, const void* sinv,
                          const GroupPlan& gp, const CrossPlan& cp, int eng,
                          const DftRes& dft, cudaStream_t stream) {
#define FFT_ROWS_T_LAUNCH(R0, R1)                                                   \
  launch_t<T, INV, R0, R1>(src_re, src_im, is, chs, channels, qstep, qim, rs, cs, \
                           re_live, im_live, live_rows, live_cols, P, M, logq, lr, \
                           rs_smem, threads, out_re, out_im, out_bf16, cosv, sinv, \
                           gp, cp, eng, dft, stream)
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
// out_bf16: store bfloat16 planes (bf16 staging; forward passes only);
// threads a multiple of 32 up to 512; levels .. xsin: the cross levels of
// this direction (levels 0 for a pow2 N; see make_cross_plan); eng:
// ENG_ROLL, or a tensor-core engine (fft_group_dft.cuh) with the
// outer-stage plan and dft the direction's tables
// (fft_group_dft_smem.cuh, fft_kernel.dft_res_tables)
extern "C" int fft_rows_t_launch(const void* src_re, const void* src_im, int in_u8,
                                 long long is, long long chs, int channels, int qstep,
                                 int qim, long long rs, long long cs, int re_live,
                                 int im_live, int live_rows, int live_cols, int P,
                                 int M, int logq, int lr, int rs_smem, int threads,
                                 void* out_re, void* out_im, int out_bf16, int inverse,
                                 const void* cosv, const void* sinv, const int* plan,
                                 int levels, const int* radix, const float* coef,
                                 const void* xcos, const void* xsin, int eng,
                                 const void* dft_tab, int tab_chunks, void* stream) {
  GroupPlan gp;
  const bool plan_ok = eng == ENG_ROLL ? read_group_plan(plan, logq, &gp)
                                       : read_mxu_plan(plan, logq, &gp) && dft_tab != nullptr;
  const DftRes dft{dft_tab, tab_chunks};
  if (levels < 0 || levels > MAX_CROSS_LEVELS || !plan_ok || threads < 32 ||
      threads > T_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  gp.direct_store = gp.direct_store && !inverse && gp.groups > 1 && eng == ENG_ROLL;
  // 16 slots a thread: every slot set full (rows * q >= 16)
  if (logq + lr < 4) return (int)cudaErrorInvalidValue;
  const CrossPlan cp = make_cross_plan(levels, radix, coef, xcos, xsin);
  const int code = radix_code(cp);
  cudaStream_t st = (cudaStream_t)stream;
#define FFT_ROWS_T_ARGS                                                              \
  code, src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live,     \
      live_rows, live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_bf16, \
      cosv, sinv, gp, cp, eng, dft, st
  if (in_u8)
    return inverse ? launch_radices<uint8_t, true>(FFT_ROWS_T_ARGS)
                   : launch_radices<uint8_t, false>(FFT_ROWS_T_ARGS);
  return inverse ? launch_radices<float, true>(FFT_ROWS_T_ARGS)
                 : launch_radices<float, false>(FFT_ROWS_T_ARGS);
#undef FFT_ROWS_T_ARGS
}
#endif  // FFT_STAGE_TU, FFT_MXU_TU
