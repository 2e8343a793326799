// fft_rows: the row FFT with the row-major stores (B6's natural store,
// B3's packed store and min/max partials), its radix-2 stages held in
// registers.
//
// Replaces two Pallas kernels of fft_restoration_tpu/ops/pallas/
// fft_kernel.py that share one stage body (_run_stages) and differ only
// in how they store:
//   B6 fft_rows_pallas plain path ("fftr_rows_*"): (P, M, N) -> (P, M, N)
//   B3 fft_rows_packed_out ("fftr_rows_packed_inv"): re -> plane 2p, im ->
//      plane 2p+1 of one (2P, M, N) output, plus [min_re, max_re, min_im,
//      max_im] partials
// The third, B1 _fft_rows_transposed, the transposed store, is
// fft_rows_t.cu; both run their stages on fft_groups.cuh's engine.
// Ordering revorder: forward = DIF (natural in, bit-reversed out),
// inverse = DIT (bit-reversed in, natural out), unscaled, at a pow2 N or
// a smooth N = R * q (R = R0 * R1 of the odd radices, q = 2^S). Natural
// ordering (pow2 N; B6's ordering="natural", the generic API's `pallas`
// backend): the JAX kernel bit-reverses the input (an XLA pass) and runs
// the DIT stages with the direction's tables (fft_kernel.py:1042-1049);
// here the first DIT group loads the bit-reversed row straight from
// device memory (fft_groups.cuh LD_BREV), so the reversal costs no pass.
//
// What bounds it on the H100: each row is read and written once, so a
// pass over two complex 2048^2 planes moves 134 MB, 40 us at 3.35 TB/s.
// The shared-memory design before this one ran each of the log2(q)
// stages as a full shared-memory pass with a barrier (11 at n = 2048, 8
// shared accesses a butterfly) and wrote the natural ordering's rows to
// bit-reversed shared slots with bank conflicts: 2.4-3.3x torch.fft.
//
// The design (the stage groups of fft_groups.cuh, as B1's):
// - A thread holds 16 complex values; the wrapper's plan
//   (ops/kernels/fft_kernel.py r_plan) cuts the stages into groups of <=
//   4 (11 = 4 + 4 + 3), each run in registers: S stages cost ceil(S / 4)
//   - 1 shared-memory exchanges, 2 at n = 2048.
// - Every direction loads and stores from registers, with no transpose:
//   forward (DIF) pow2, the top group loads with the row map
//   (neighbouring threads on neighbouring columns) and the bottom group
//   (s_lo = 0), which holds 2^k consecutive columns of one row, stores
//   them as 16-byte vectors; inverse (DIT), the mirror: the bottom group
//   loads vectors, the top group stores with the row map; natural, the
//   bottom group loads the bit-reversed map, the top group stores with
//   the row map. The mixed forward pass runs both cross levels in
//   registers as the rows load (cross_item) and the mixed inverse as
//   they store, as B1 does.
// - B3's min/max: each thread folds the values it stores, then the warp
//   (shuffles) and the block (block_minmax4) reduce them, one partial a
//   block; a block of more rows than a partial's (tiny planes only, where
//   a thread's 16 slots need more rows) reduces each partial's rows from
//   the output it just wrote.
// - Geometry for occupancy, by measurement (tools/rows_geometry.py): no
//   transposed store, so a block needs no minimum of rows; the plan
//   gives a natural-store block the rows that fit 32 KB (2 at n = 2048),
//   a packed-store block those of one min/max partial (4), and 128
//   threads that loop over the slot sets: 3-4 blocks an SM.
//   __launch_bounds__(256, 2) holds a thread to 128 registers, with no
//   spill. Blocks past the live rows write the zero rows and transform
//   nothing, so the wrapper allocates with torch.empty.
//
// Load: pair p reads logical plane q = p*qstep as re and q + qim as im
// (fft_rows_load.cuh's strided loader, shared with fft_rows_t.cu: zero
// outside the live pairs, rows and columns; uint8 as x / 255.0f).
// Grid: one dimension, block b takes row block b % nblk of pair b / nblk,
// so the pair count is not held to gridDim.y's 65535.
//
// The MXU engine (engine="mxu", revorder only): fft_rows_mxu_kernel<..,
// ENG> runs the outer stages 7 .. logq - 1 in the plan's groups and the
// tensor-core group DFT in place of the inner 7 (forward last, the rows
// then stored from shared memory with B3's min/max; inverse first, the
// rows loaded to shared memory). Its group DFT is fft_group_dft_smem.cuh's:
// the tables resident in shared memory (one bulk copy a block), one
// persistent block of 512 threads an SM walking over the row blocks
// (r_plan(mxu=True) at n = 2048: B3 4 rows, one min/max partial, beside
// all the tables; B6 8 rows beside 62 of the 64 'default' chunks), the
// rows loaded and stored as 16-byte vectors, the zero rows past the live
// ones stored as 16-byte vectors too. The design before (the L2 design:
// group_dft reading the tables through L1 and L2 for every 8 groups, 128
// threads and 4 rows (B3) or 2 (B6) a block at n = 2048) took 0.1817 /
// 0.4211 ms ('default' / 'highest') for B3 at 2 x 2048^2 and 0.0538 /
// 0.1729 for B6's PSF pass on an H100 at 700 W, against torch.fft's 0.052
// / 0.030. The forward passes at 'default' keep that design,
// fft_rows_l2_kernel, which an H100 runs faster there (B6's PSF pass and
// its bf16-staged twin). fft_rows_kernel keeps its parameters and code.
//
// bf16 staging (stage_dtype="bf16": the JAX _load_f32 of bfloat16 planes
// in fft_rows_pallas and fft_rows_packed_out): both kernels' instances at
// T = __nv_bfloat16 read bfloat16 planes, widened in the load (the bottom
// group of an inverse pass reads 8 values a 16-byte vector), at either
// engine: B6's forward pass of inverse and CLS, B3 after B2. Their outputs
// stay float32. They build in translation units of their own
// (FFT_STAGE_TU, one an engine), so every float32 and uint8 instance
// keeps its machine code.
#include "fft_group_dft_smem.cuh"

#define R_THREADS 256
#define R_MIN_BLOCKS 2
#define R_MXU_THREADS 512  // fft_rows_mxu_kernel: one block an SM

enum { MODE_DIF = 0, MODE_DIT = 1, MODE_NATURAL = 2 };

// a forward group: LD_ROW for the pow2 pass's first, ST_VEC for the last
// (a pow2 pass of one group, q <= 16, stores through shared memory: its
// group loading and storing device memory at once spilled the uint8
// instance)
template <int R, typename T>
__device__ __forceinline__ void dif_group(const TBlock& tb, const GroupPlan& gp, int g,
                                          const PairLoad<T>& ld, bool mm_on, float (&mm)[4]) {
  const bool last = g == gp.groups - 1;
  if constexpr (R == 1) {
    if (g == 0) {
      run_group<false, LD_ROW, ST_SMEM>(tb, gp, g, ld, mm_on, mm);
      return;
    }
  }
  if (last)
    run_group<false, LD_SMEM, ST_VEC>(tb, gp, g, ld, mm_on, mm);
  else
    run_group<false, LD_SMEM, ST_SMEM>(tb, gp, g, ld, mm_on, mm);
}

// an inverse or natural group: LD0 (LD_VEC or LD_BREV) for the bottom
// group, ST_ROW for the top group of a pow2 pass (the mixed pass stores
// after its cross levels)
template <int R, int LD0, typename T>
__device__ __forceinline__ void dit_group(const TBlock& tb, const GroupPlan& gp, int g,
                                          const PairLoad<T>& ld, bool mm_on, float (&mm)[4]) {
  const bool bottom = g == gp.groups - 1;
  if constexpr (R == 1) {
    if (g == 0) {
      if (bottom)
        run_group<true, LD0, ST_ROW>(tb, gp, g, ld, mm_on, mm);
      else
        run_group<true, LD_SMEM, ST_ROW>(tb, gp, g, ld, mm_on, mm);
      return;
    }
  }
  if (bottom)
    run_group<true, LD0, ST_SMEM>(tb, gp, g, ld, mm_on, mm);
  else
    run_group<true, LD_SMEM, ST_SMEM>(tb, gp, g, ld, mm_on, mm);
}

// N = R0 * R1 * 2^logq; rows = 2^lr rows a block; rs_smem the padded row
// stride; block b takes rows m0 = (b % nblk) * rows of pair b / nblk.
// Output: pair p's re plane at out_re + p * out_pair, its im plane at
// out_im + p * out_pair, (M, N) row-major each. minmax (B3): non-null for
// the partials of 2^lpg rows each (lpg <= lr), partial u of pair p at
// minmax[(p * (M >> lpg) + u) * 4].
template <typename T, int MODE, int R0, int R1>
__global__ void __launch_bounds__(R_THREADS, R_MIN_BLOCKS)
fft_rows_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                long long is, long long chs, int channels, int qstep, int qim,
                long long rs, long long cs, int re_live, int im_live,
                int live_rows, int live_cols, int M, int logq, int lr, int rs_smem,
                int nblk, float* __restrict__ out_re, float* __restrict__ out_im,
                long long out_pair, float* __restrict__ minmax, int lpg,
                const float* __restrict__ cosv, const float* __restrict__ sinv,
                const __grid_constant__ GroupPlan gp,
                const __grid_constant__ CrossPlan cp) {
  constexpr int R = R0 * R1;
  extern __shared__ float smem[];
  const int rows = 1 << lr;
  const int q = 1 << logq;
  const int N = R * q;
  const int p = blockIdx.x / nblk;
  const int blk = blockIdx.x - p * nblk;
  const int m0 = blk * rows;
  float* ore = out_re + p * out_pair + (size_t)m0 * N;
  float* oim = out_im + p * out_pair + (size_t)m0 * N;

  if (m0 >= live_rows) {  // rows past the live ones: zeros, no transform
    const int n = min(rows, M - m0) * N;  // contiguous, even
    for (int t = 2 * threadIdx.x; t < n; t += 2 * blockDim.x) {
      *reinterpret_cast<float2*>(ore + t) = make_float2(0.0f, 0.0f);
      *reinterpret_cast<float2*>(oim + t) = make_float2(0.0f, 0.0f);
    }
    return;
  }

  const TBlock tb = {smem, smem + rows * rs_smem, rs_smem, logq, lr, (rows * N) >> 4,
                     N, cosv, sinv, ore, oim, M, m0};
  const PairLoad<T> ld(src_re, src_im, is, chs, channels, qstep, qim, rs, cs,
                       re_live, im_live, live_rows, live_cols, p, m0);
  // B3's partials: float32 / bfloat16 revorder passes only (the C entry refuses the rest)
  const bool mm_on = !std::is_same<T, uint8_t>::value && MODE != MODE_NATURAL && minmax != nullptr;
  float mm[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};

  if constexpr (MODE == MODE_DIF) {
    if constexpr (R > 1) {  // load + both cross levels, item (row, b): b fastest
      for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
        const int b = t & (q - 1), r = t >> logq;
        const auto row = ld.row(r);
        float xr[R], xi[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float2 v = ld.at(row, b + j * q);
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
      if (g) __syncthreads();
      dif_group<R>(tb, gp, g, ld, mm_on, mm);
    }
    if (R == 1 && gp.groups == 1) {  // the one-group pass's store
      __syncthreads();
      for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
        const int r = t >> logq;
        if (m0 + r >= M) continue;
        const int a = r * rs_smem + pad_idx(t & (q - 1));
        ore[t] = tb.sre[a];
        oim[t] = tb.sim[a];
        if (mm_on) fold_minmax(mm, tb.sre[a], tb.sim[a]);
      }
    }
  } else {
    for (int g = gp.groups - 1; g >= 0; --g) {
      if (g < gp.groups - 1) __syncthreads();
      dit_group<R, MODE == MODE_NATURAL ? LD_BREV : LD_VEC>(tb, gp, g, ld, mm_on, mm);
    }
    if constexpr (R > 1) {  // both inverse cross levels, then the row store
      __syncthreads();
      for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
        const int b = t & (q - 1), r = t >> logq;
        if (m0 + r >= M) continue;
        float xr[R], xi[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int a = r * rs_smem + pad_idx(b + j * q);
          xr[j] = tb.sre[a];
          xi[j] = tb.sim[a];
        }
        cross_item<R0, R1, true>(xr, xi, b, q, N, cp);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          ore[r * N + b + j * q] = xr[j];
          oim[r * N + b + j * q] = xi[j];
          if (mm_on) fold_minmax(mm, xr[j], xi[j]);
        }
      }
    }
  }

  if (!mm_on) return;
  if (lpg == lr) {  // one partial a block
    block_minmax4(mm, minmax + ((size_t)p * nblk + blk) * 4);
    return;
  }
  // several partials a block: each from the rows this block just stored
  __syncthreads();
  const size_t part = (size_t)p * (M >> lpg) + (m0 >> lpg);
  const int n = N << lpg;
  for (int u = 0; u < rows >> lpg && m0 + (u << lpg) < M; ++u) {
    float v[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};
    for (int t = threadIdx.x; t < n; t += blockDim.x) fold_minmax(v, ore[u * n + t], oim[u * n + t]);
    block_minmax4(v, minmax + (part + u) * 4);
    __syncthreads();
  }
}

// The MXU engine's instances (ENG_BF16 or ENG_TF32X3, MODE_DIF or
// MODE_DIT, revorder only), the parameters as fft_rows_kernel's and
// blocks = nblk * P row blocks: a persistent block walks over them (block
// b as fft_rows_kernel's block b), the outer stages 7 .. logq - 1 in the
// plan's groups and the group DFT (fft_group_dft_smem.cuh; dft the pass
// direction's tables, their first tab_chunks chunks copied into the front
// of the block's shared memory as it starts, the rest read from dft) in
// place of the inner 7: forward, the outer
// groups (the top one loading the row map at pow2), the group DFT, then
// the rows stored from shared memory as 16-byte vectors (B3's min/max
// folded as they go); inverse, the rows loaded to shared memory as
// vectors, the inverse group DFT, then the outer groups (the top one
// storing the row map at pow2) or the cross levels as in fft_rows_kernel,
// whose code stays its own.
template <typename T, int MODE, int R0, int R1, int ENG>
__global__ void __launch_bounds__(R_MXU_THREADS, 1)
fft_rows_mxu_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                    long long is, long long chs, int channels, int qstep, int qim,
                    long long rs, long long cs, int re_live, int im_live,
                    int live_rows, int live_cols, int M, int logq, int lr, int rs_smem,
                    int nblk, float* __restrict__ out_re, float* __restrict__ out_im,
                    long long out_pair, float* __restrict__ minmax, int lpg,
                    const float* __restrict__ cosv, const float* __restrict__ sinv,
                    const __grid_constant__ GroupPlan gp,
                    const __grid_constant__ CrossPlan cp, const void* __restrict__ dft,
                    int blocks, int tab_chunks) {
  static_assert(MODE != MODE_NATURAL, "the MXU engine takes revorder passes");
  constexpr int R = R0 * R1;
  // the tables' first tab_chunks chunks in front of the shared rows
  extern __shared__ __align__(16) unsigned char r_smem[];
  const int tab_bytes = tab_chunks * dft_res_chunk_bytes(ENG);
  uint64_t* bar = reinterpret_cast<uint64_t*>(r_smem + tab_bytes);
  float* srows = reinterpret_cast<float*>(r_smem + tab_bytes + DFT_RES_BAR);
  if (tab_bytes) dft_tables_start(r_smem, dft, tab_bytes, bar);
  const int rows = 1 << lr;
  const int q = 1 << logq;
  const int N = R * q;
  // B3's partials: float32 / bfloat16 revorder passes only (the C entry refuses the rest)
  const bool mm_on = !std::is_same<T, uint8_t>::value && minmax != nullptr;
  for (int rb = blockIdx.x; rb < blocks; rb += gridDim.x) {
    const int p = rb / nblk;
    const int blk = rb - p * nblk;
    const int m0 = blk * rows;
    float* ore = out_re + p * out_pair + (size_t)m0 * N;
    float* oim = out_im + p * out_pair + (size_t)m0 * N;

    if (m0 >= live_rows) {  // rows past the live ones: zeros, no transform
      const int n = min(rows, M - m0) * N;  // contiguous, a multiple of 4
      if (((reinterpret_cast<uintptr_t>(ore) | reinterpret_cast<uintptr_t>(oim)) & 15) == 0) {
        for (int t = 4 * threadIdx.x; t < n; t += 4 * blockDim.x) {
          *reinterpret_cast<float4*>(ore + t) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          *reinterpret_cast<float4*>(oim + t) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        for (int t = 2 * threadIdx.x; t < n; t += 2 * blockDim.x) {
          *reinterpret_cast<float2*>(ore + t) = make_float2(0.0f, 0.0f);
          *reinterpret_cast<float2*>(oim + t) = make_float2(0.0f, 0.0f);
        }
      }
      continue;
    }

    const TBlock tb = {srows, srows + rows * rs_smem, rs_smem, logq, lr, (rows * N) >> 4,
                       N, cosv, sinv, ore, oim, M, m0};
    const PairLoad<T> ld(src_re, src_im, is, chs, channels, qstep, qim, rs, cs,
                         re_live, im_live, live_rows, live_cols, p, m0);
    float mm[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};
    const SmemEpi epi{tb.sre, tb.sim, rs_smem};
    if constexpr (MODE == MODE_DIF) {
      if constexpr (R > 1) {  // load + both cross levels, item (row, b): b fastest
        for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
          const int b = t & (q - 1), r = t >> logq;
          const auto row = ld.row(r);
          float xr[R], xi[R];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float2 v = ld.at(row, b + j * q);
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
      } else if (gp.groups == 0) {  // q = 128: element by element, as B1's forward pass
        for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
          const int r = t >> logq, c = t & (q - 1);
          const float2 v = ld.get(r, c);
          tb.sre[r * rs_smem + pad_idx(c)] = v.x;
          tb.sim[r * rs_smem + pad_idx(c)] = v.y;
        }
        __syncthreads();
      }
      for (int g = 0; g < gp.groups; ++g) {
        if (R == 1 && g == 0)
          run_group<false, LD_ROW, ST_SMEM>(tb, gp, g, ld, false, mm);
        else
          run_group<false, LD_SMEM, ST_SMEM>(tb, gp, g, ld, false, mm);
        __syncthreads();
      }
      if (tab_bytes) dft_tables_wait(bar);
      group_dft_res<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, r_smem, tab_chunks,
                         dft, epi);
      __syncthreads();
      // the rows from shared memory as 16-byte vectors (4 columns a thread:
      // conflict-free, as rows_to_smem's stores)
      for (int r = 0; r < rows && m0 + r < M; ++r) {
        for (int c = 4 * threadIdx.x; c < N; c += 4 * blockDim.x) {
          float vr[4], vi[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            vr[e] = tb.sre[r * rs_smem + pad_idx(c + e)];
            vi[e] = tb.sim[r * rs_smem + pad_idx(c + e)];
            if (mm_on) fold_minmax(mm, vr[e], vi[e]);
          }
          store_vec<4>(ore + r * N + c, vr);
          store_vec<4>(oim + r * N + c, vi);
        }
      }
    } else {
      rows_to_smem(tb, ld, rows, N);
      __syncthreads();
      if (tab_bytes) dft_tables_wait(bar);
      group_dft_res<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, r_smem, tab_chunks,
                         dft, epi);
      __syncthreads();
      for (int g = gp.groups - 1; g >= 0; --g) {
        if (R == 1 && g == 0) {
          run_group<true, LD_SMEM, ST_ROW>(tb, gp, g, ld, mm_on, mm);
        } else {
          run_group<true, LD_SMEM, ST_SMEM>(tb, gp, g, ld, false, mm);
          __syncthreads();
        }
      }
      if constexpr (R > 1) {  // both inverse cross levels, then the row store
        for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
          const int b = t & (q - 1), r = t >> logq;
          if (m0 + r >= M) continue;
          float xr[R], xi[R];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int a = r * rs_smem + pad_idx(b + j * q);
            xr[j] = tb.sre[a];
            xi[j] = tb.sim[a];
          }
          cross_item<R0, R1, true>(xr, xi, b, q, N, cp);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            ore[r * N + b + j * q] = xr[j];
            oim[r * N + b + j * q] = xi[j];
            if (mm_on) fold_minmax(mm, xr[j], xi[j]);
          }
        }
      } else if (gp.groups == 0) {  // q = 128: the rows as stored above
        for (int r = 0; r < rows && m0 + r < M; ++r) {
          for (int c = 4 * threadIdx.x; c < N; c += 4 * blockDim.x) {
            float vr[4], vi[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              vr[e] = tb.sre[r * rs_smem + pad_idx(c + e)];
              vi[e] = tb.sim[r * rs_smem + pad_idx(c + e)];
              if (mm_on) fold_minmax(mm, vr[e], vi[e]);
            }
            store_vec<4>(ore + r * N + c, vr);
            store_vec<4>(oim + r * N + c, vi);
          }
        }
      }
    }

    if (mm_on) {
      if (lpg == lr) {  // one partial a block
        block_minmax4(mm, minmax + ((size_t)p * nblk + blk) * 4);
      } else {  // several partials a block: each from the rows this block just stored
        __syncthreads();
        const size_t part = (size_t)p * (M >> lpg) + (m0 >> lpg);
        const int n = N << lpg;
        for (int u = 0; u < rows >> lpg && m0 + (u << lpg) < M; ++u) {
          float v[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};
          for (int t = threadIdx.x; t < n; t += blockDim.x)
            fold_minmax(v, ore[u * n + t], oim[u * n + t]);
          block_minmax4(v, minmax + (part + u) * 4);
          __syncthreads();
        }
      }
    }
    __syncthreads();  // the shared rows read before the next row block lands
  }
  // no block leaves with the copy in flight: thread 0, which started it,
  // waits (the others may not have met a barrier since its mbarrier.init)
  if (tab_bytes && threadIdx.x == 0) dft_tables_wait(bar);
}

// The forward passes at 'default' (MODE_DIF, ENG_BF16): the L2 design's
// MXU instance (group_dft reading its tables through L1 and L2, one block of
// r_plan(mxu=True, resident=False)'s rows a row block, the rows stored
// element by element), which an H100 runs 5-16% faster than the resident
// design's forward pass; its code as the L2 design wrote it for both
// modes and engines, instantiated for that one
template <typename T, int MODE, int R0, int R1, int ENG>
__global__ void __launch_bounds__(R_THREADS, R_MIN_BLOCKS)
fft_rows_l2_kernel(const T* __restrict__ src_re, const T* __restrict__ src_im,
                   long long is, long long chs, int channels, int qstep, int qim,
                   long long rs, long long cs, int re_live, int im_live,
                   int live_rows, int live_cols, int M, int logq, int lr, int rs_smem,
                   int nblk, float* __restrict__ out_re, float* __restrict__ out_im,
                   long long out_pair, float* __restrict__ minmax, int lpg,
                   const float* __restrict__ cosv, const float* __restrict__ sinv,
                   const __grid_constant__ GroupPlan gp,
                   const __grid_constant__ CrossPlan cp, const void* __restrict__ dft) {
  constexpr int R = R0 * R1;
  extern __shared__ float smem[];
  const int rows = 1 << lr;
  const int q = 1 << logq;
  const int N = R * q;
  const int p = blockIdx.x / nblk;
  const int blk = blockIdx.x - p * nblk;
  const int m0 = blk * rows;
  float* ore = out_re + p * out_pair + (size_t)m0 * N;
  float* oim = out_im + p * out_pair + (size_t)m0 * N;

  if (m0 >= live_rows) {  // rows past the live ones: zeros, no transform
    const int n = min(rows, M - m0) * N;  // contiguous, even
    for (int t = 2 * threadIdx.x; t < n; t += 2 * blockDim.x) {
      *reinterpret_cast<float2*>(ore + t) = make_float2(0.0f, 0.0f);
      *reinterpret_cast<float2*>(oim + t) = make_float2(0.0f, 0.0f);
    }
    return;
  }

  const TBlock tb = {smem, smem + rows * rs_smem, rs_smem, logq, lr, (rows * N) >> 4,
                     N, cosv, sinv, ore, oim, M, m0};
  const PairLoad<T> ld(src_re, src_im, is, chs, channels, qstep, qim, rs, cs,
                       re_live, im_live, live_rows, live_cols, p, m0);
  // B3's partials: float32 / bfloat16 revorder passes only (the C entry refuses the rest)
  const bool mm_on = !std::is_same<T, uint8_t>::value && MODE != MODE_NATURAL && minmax != nullptr;
  float mm[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};

  static_assert(MODE != MODE_NATURAL, "the MXU engine takes revorder passes");
  // the block's rows to and from the shared rows, element by element
  auto load_rows = [&]() {
    for (int r = 0; r < rows; ++r) {
      const auto row = ld.row(r);
      for (int c = threadIdx.x; c < N; c += blockDim.x) {
        const float2 v = ld.at(row, c);
        tb.sre[r * rs_smem + pad_idx(c)] = v.x;
        tb.sim[r * rs_smem + pad_idx(c)] = v.y;
      }
    }
  };
  auto store_rows = [&]() {
    for (int r = 0; r < rows && m0 + r < M; ++r) {
      for (int c = threadIdx.x; c < N; c += blockDim.x) {
        const float xr = tb.sre[r * rs_smem + pad_idx(c)], xi = tb.sim[r * rs_smem + pad_idx(c)];
        ore[r * N + c] = xr;
        oim[r * N + c] = xi;
        if (mm_on) fold_minmax(mm, xr, xi);
      }
    }
  };
  const SmemEpi epi{tb.sre, tb.sim, rs_smem};
  if constexpr (MODE == MODE_DIF) {
    if constexpr (R > 1) {  // load + both cross levels, item (row, b): b fastest
      for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
        const int b = t & (q - 1), r = t >> logq;
        const auto row = ld.row(r);
        float xr[R], xi[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float2 v = ld.at(row, b + j * q);
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
    } else if (gp.groups == 0) {
      load_rows();
      __syncthreads();
    }
    for (int g = 0; g < gp.groups; ++g) {
      if (R == 1 && g == 0)
        run_group<false, LD_ROW, ST_SMEM>(tb, gp, g, ld, false, mm);
      else
        run_group<false, LD_SMEM, ST_SMEM>(tb, gp, g, ld, false, mm);
      __syncthreads();
    }
    group_dft<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, dft, epi);
    __syncthreads();
    store_rows();
  } else {
    load_rows();
    __syncthreads();
    group_dft<ENG>(tb.sre, tb.sim, rs_smem, rows, N >> DFT_LOG, dft, epi);
    __syncthreads();
    for (int g = gp.groups - 1; g >= 0; --g) {
      if (R == 1 && g == 0) {
        run_group<true, LD_SMEM, ST_ROW>(tb, gp, g, ld, mm_on, mm);
      } else {
        run_group<true, LD_SMEM, ST_SMEM>(tb, gp, g, ld, false, mm);
        __syncthreads();
      }
    }
    if constexpr (R > 1) {  // both inverse cross levels, then the row store
      for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
        const int b = t & (q - 1), r = t >> logq;
        if (m0 + r >= M) continue;
        float xr[R], xi[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int a = r * rs_smem + pad_idx(b + j * q);
          xr[j] = tb.sre[a];
          xi[j] = tb.sim[a];
        }
        cross_item<R0, R1, true>(xr, xi, b, q, N, cp);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          ore[r * N + b + j * q] = xr[j];
          oim[r * N + b + j * q] = xi[j];
          if (mm_on) fold_minmax(mm, xr[j], xi[j]);
        }
      }
    } else if (gp.groups == 0) {
      store_rows();
    }
  }

  if (!mm_on) return;
  if (lpg == lr) {  // one partial a block
    block_minmax4(mm, minmax + ((size_t)p * nblk + blk) * 4);
    return;
  }
  // several partials a block: each from the rows this block just stored
  __syncthreads();
  const size_t part = (size_t)p * (M >> lpg) + (m0 >> lpg);
  const int n = N << lpg;
  for (int u = 0; u < rows >> lpg && m0 + (u << lpg) < M; ++u) {
    float v[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};
    for (int t = threadIdx.x; t < n; t += blockDim.x) fold_minmax(v, ore[u * n + t], oim[u * n + t]);
    block_minmax4(v, minmax + (part + u) * 4);
    __syncthreads();
  }
}

// the arguments of one launch, as the C entry passes them on
#define FFT_ROWS_LAUNCH_PARAMS                                                           \
  const void *src_re, const void *src_im, long long is, long long chs, int channels,    \
      int qstep, int qim, long long rs, long long cs, int re_live, int im_live,         \
      int live_rows, int live_cols, int P, int M, int logq, int lr, int rs_smem,        \
      int threads, void *out_re, void *out_im, long long out_pair, void *minmax, int lpg, \
      const void *cosv, const void *sinv, const GroupPlan &gp, const CrossPlan &cp,      \
      const DftRes &dft, cudaStream_t stream
#define FFT_ROWS_KERNEL_ARGS                                                                \
  nblk * P, threads, smem, stream, (const T*)src_re, (const T*)src_im, is, chs, channels,  \
      qstep, qim, rs, cs, re_live, im_live, live_rows, live_cols, M, logq, lr, rs_smem,    \
      nblk, (float*)out_re, (float*)out_im, out_pair, (float*)minmax, lpg,                 \
      (const float*)cosv, (const float*)sinv, gp, cp

// The launch of an MXU instance (ENG_BF16 or ENG_TF32X3; MODE_DIF or
// MODE_DIT), built in translation units of their own as fft_rows_t.cu's
template <typename T, int MODE, int R0, int R1, int ENG>
int launch_r_mxu(FFT_ROWS_LAUNCH_PARAMS);
// the launch of a bf16-input instance (MODE_DIF or MODE_DIT) at engine ENG,
// built in the FFT_STAGE_TU units
template <int MODE, int R0, int R1, int ENG>
int launch_r_bf16(FFT_ROWS_LAUNCH_PARAMS);

// fft_rows_mxu_kernel's launch: dft.chunks of the tables in front of the
// rows, at most one persistent block a slot of the card
template <typename T, int MODE, int R0, int R1, int ENG>
int launch_r_res(FFT_ROWS_LAUNCH_PARAMS) {
  const long long smem = dft_res_smem<ENG>(dft, 2 * sizeof(float) * ((size_t)rs_smem << lr));
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const int rows = 1 << lr;
  const int nblk = (M + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return start_persistent(fft_rows_mxu_kernel<T, MODE, R0, R1, ENG>, nblk * P, threads,
                          (size_t)smem, stream, (const T*)src_re, (const T*)src_im, is, chs,
                          channels, qstep, qim, rs, cs, re_live, im_live, live_rows, live_cols,
                          M, logq, lr, rs_smem, nblk, (float*)out_re, (float*)out_im, out_pair,
                          (float*)minmax, lpg, (const float*)cosv, (const float*)sinv, gp, cp,
                          dft.tab, nblk * P, dft.chunks);
}

// fft_rows_l2_kernel's launch (no table chunks: dft.chunks 0), one block
// a row block
template <typename T, int R0, int R1>
int launch_r_l2(FFT_ROWS_LAUNCH_PARAMS) {
  if (dft.tab == nullptr || dft.chunks != 0 || threads > R_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
  const int rows = 1 << lr;
  const int nblk = (M + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return start_kernel(fft_rows_l2_kernel<T, MODE_DIF, R0, R1, ENG_BF16>, FFT_ROWS_KERNEL_ARGS,
                      dft.tab);
}

#if defined(FFT_STAGE_TU)
template <int MODE, int R0, int R1, int ENG>
int launch_r_bf16(FFT_ROWS_LAUNCH_PARAMS) {
  using T = __nv_bfloat16;
  if constexpr (MODE == MODE_DIF && ENG == ENG_BF16) {
    return launch_r_l2<T, R0, R1>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_pair, minmax, lpg,
        cosv, sinv, gp, cp, dft, stream);
  } else if constexpr (ENG != ENG_ROLL) {
    return launch_r_res<T, MODE, R0, R1, ENG>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_pair, minmax, lpg,
        cosv, sinv, gp, cp, dft, stream);
  } else {
    const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
    const int rows = 1 << lr;
    const int nblk = (M + rows - 1) / rows;
    if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    return start_kernel(fft_rows_kernel<T, MODE, R0, R1>, FFT_ROWS_KERNEL_ARGS);
  }
}

#define FFT_ROWS_BF16(MODE)                                                             \
  template int launch_r_bf16<MODE, 1, 1, FFT_STAGE_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_bf16<MODE, 3, 1, FFT_STAGE_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_bf16<MODE, 5, 1, FFT_STAGE_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_bf16<MODE, 3, 3, FFT_STAGE_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_bf16<MODE, 3, 5, FFT_STAGE_TU>(FFT_ROWS_LAUNCH_PARAMS);
FFT_ROWS_BF16(MODE_DIF)
FFT_ROWS_BF16(MODE_DIT)
#undef FFT_ROWS_BF16
#elif defined(FFT_MXU_TU)
template <typename T, int MODE, int R0, int R1, int ENG>
int launch_r_mxu(FFT_ROWS_LAUNCH_PARAMS) {
  if constexpr (MODE == MODE_DIF && ENG == ENG_BF16)
    return launch_r_l2<T, R0, R1>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_pair, minmax, lpg,
        cosv, sinv, gp, cp, dft, stream);
  else
    return launch_r_res<T, MODE, R0, R1, ENG>(
        src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,
        live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_pair, minmax, lpg,
        cosv, sinv, gp, cp, dft, stream);
}

#define FFT_ROWS_MXU(T, MODE)                                                           \
  template int launch_r_mxu<T, MODE, 1, 1, FFT_MXU_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_mxu<T, MODE, 3, 1, FFT_MXU_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_mxu<T, MODE, 5, 1, FFT_MXU_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_mxu<T, MODE, 3, 3, FFT_MXU_TU>(FFT_ROWS_LAUNCH_PARAMS);        \
  template int launch_r_mxu<T, MODE, 3, 5, FFT_MXU_TU>(FFT_ROWS_LAUNCH_PARAMS);
FFT_ROWS_MXU(float, MODE_DIF)
FFT_ROWS_MXU(float, MODE_DIT)
FFT_ROWS_MXU(uint8_t, MODE_DIF)
FFT_ROWS_MXU(uint8_t, MODE_DIT)
#undef FFT_ROWS_MXU
#else

template <typename T, int MODE, int R0, int R1>
static int launch_r(const void* src_re, const void* src_im, long long is, long long chs,
                    int channels, int qstep, int qim, long long rs, long long cs, int re_live,
                    int im_live, int live_rows, int live_cols, int P, int M, int logq, int lr,
                    int rs_smem, int threads, void* out_re, void* out_im, long long out_pair,
                    void* minmax, int lpg, const void* cosv, const void* sinv,
                    const GroupPlan& gp, const CrossPlan& cp, int eng, const DftRes& dft,
                    cudaStream_t stream) {
#define FFT_ROWS_MXU_ARGS                                                                   \
  src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows,      \
      live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_pair, minmax, lpg,  \
      cosv, sinv, gp, cp, dft, stream
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // bf16 staging: revorder only
    if constexpr (MODE == MODE_NATURAL) {
      return (int)cudaErrorInvalidValue;
    } else {
      switch (eng) {
        case ENG_ROLL: return launch_r_bf16<MODE, R0, R1, ENG_ROLL>(FFT_ROWS_MXU_ARGS);
        case ENG_BF16: return launch_r_bf16<MODE, R0, R1, ENG_BF16>(FFT_ROWS_MXU_ARGS);
        case ENG_TF32X3: return launch_r_bf16<MODE, R0, R1, ENG_TF32X3>(FFT_ROWS_MXU_ARGS);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  } else {
    if (eng == ENG_ROLL) {
      const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
      const int rows = 1 << lr;
      const int nblk = (M + rows - 1) / rows;
      if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
      return start_kernel(fft_rows_kernel<T, MODE, R0, R1>, FFT_ROWS_KERNEL_ARGS);
    }
    if constexpr (MODE == MODE_NATURAL) {  // roll only
      return (int)cudaErrorInvalidValue;
    } else {
      switch (eng) {
        case ENG_BF16: return launch_r_mxu<T, MODE, R0, R1, ENG_BF16>(FFT_ROWS_MXU_ARGS);
        case ENG_TF32X3: return launch_r_mxu<T, MODE, R0, R1, ENG_TF32X3>(FFT_ROWS_MXU_ARGS);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
#undef FFT_ROWS_MXU_ARGS
}

template <typename T, int MODE>
static int launch_radices(int code, const void* src_re, const void* src_im, long long is,
                          long long chs, int channels, int qstep, int qim, long long rs,
                          long long cs, int re_live, int im_live, int live_rows, int live_cols,
                          int P, int M, int logq, int lr, int rs_smem, int threads,
                          void* out_re, void* out_im, long long out_pair, void* minmax,
                          int lpg, const void* cosv, const void* sinv, const GroupPlan& gp,
                          const CrossPlan& cp, int eng, const DftRes& dft, cudaStream_t stream) {
#define FFT_ROWS_LAUNCH(R0, R1)                                                              \
  launch_r<T, MODE, R0, R1>(src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, \
                            im_live, live_rows, live_cols, P, M, logq, lr, rs_smem, threads, \
                            out_re, out_im, out_pair, minmax, lpg, cosv, sinv, gp, cp, eng, dft, \
                            stream)
  if constexpr (MODE == MODE_NATURAL) {  // pow2 only
    return code == 0 ? FFT_ROWS_LAUNCH(1, 1) : (int)cudaErrorInvalidValue;
  } else {
    switch (code) {
      case 0: return FFT_ROWS_LAUNCH(1, 1);
      case 1: return FFT_ROWS_LAUNCH(3, 1);
      case 2: return FFT_ROWS_LAUNCH(5, 1);
      case 3: return FFT_ROWS_LAUNCH(3, 3);
      case 4: return FFT_ROWS_LAUNCH(3, 5);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef FFT_ROWS_LAUNCH
}

template <typename T>
static int launch_modes(int mode, int code, const void* src_re, const void* src_im,
                        long long is, long long chs, int channels, int qstep, int qim,
                        long long rs, long long cs, int re_live, int im_live, int live_rows,
                        int live_cols, int P, int M, int logq, int lr, int rs_smem, int threads,
                        void* out_re, void* out_im, long long out_pair, void* minmax, int lpg,
                        const void* cosv, const void* sinv, const GroupPlan& gp,
                        const CrossPlan& cp, int eng, const DftRes& dft, cudaStream_t stream) {
#define FFT_ROWS_ARGS                                                                       \
  code, src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, live_rows, \
      live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_pair, minmax, lpg,   \
      cosv, sinv, gp, cp, eng, dft, stream
  switch (mode) {
    case MODE_DIF: return launch_radices<T, MODE_DIF>(FFT_ROWS_ARGS);
    case MODE_DIT: return launch_radices<T, MODE_DIT>(FFT_ROWS_ARGS);
    default: return launch_radices<T, MODE_NATURAL>(FFT_ROWS_ARGS);
  }
#undef FFT_ROWS_ARGS
}

// in_dtype: the planes' element type (IN_F32, IN_U8, IN_BF16: bf16
// staging, revorder only); logq = S; lr = log2(rows); rs_smem the padded
// row stride; threads a multiple of 32 up to 256 (512 for a tensor-core
// engine); plan: the wrapper's r_plan (fft_groups.cuh read_group_plan);
// out_pair: floats between two pairs' output planes;
// minmax: null, or the partials of 2^lpg rows each (lpg <= lr; float32 or
// bfloat16 revorder only); natural:
// natural ordering (pow2 N, levels 0); levels .. xsin: the cross levels
// of this direction (levels 0 for a pow2 N; see make_cross_plan); eng:
// ENG_ROLL, or a tensor-core engine (fft_group_dft.cuh, revorder only)
// with the outer-stage plan and dft the direction's tables
// (fft_group_dft_smem.cuh, fft_kernel.dft_res_tables)
enum { IN_F32 = 0, IN_U8 = 1, IN_BF16 = 2 };
extern "C" int fft_rows_launch(const void* src_re, const void* src_im, int in_dtype,
                               long long is, long long chs, int channels, int qstep, int qim,
                               long long rs, long long cs, int re_live, int im_live,
                               int live_rows, int live_cols, int P, int M, int logq, int lr,
                               int rs_smem, int threads, void* out_re, void* out_im,
                               long long out_pair, void* minmax, int lpg, int inverse,
                               int natural, const void* cosv, const void* sinv, const int* plan,
                               int levels, const int* radix, const float* coef,
                               const void* xcos, const void* xsin, int eng,
                               const void* dft_tab, int tab_chunks, void* stream) {
  GroupPlan gp;
  const bool plan_ok = eng == ENG_ROLL
                           ? read_group_plan(plan, logq, &gp)
                           : read_mxu_plan(plan, logq, &gp) && dft_tab != nullptr && !natural;
  const DftRes dft{dft_tab, tab_chunks};
  if (levels < 0 || levels > MAX_CROSS_LEVELS || !plan_ok ||
      threads < 32 || threads > (eng == ENG_ROLL ? R_THREADS : R_MXU_THREADS) ||
      threads % 32 || logq + lr < 4 ||
      in_dtype < IN_F32 || in_dtype > IN_BF16 || (in_dtype == IN_BF16 && natural) ||
      (minmax != nullptr && (lpg < 0 || lpg > lr || in_dtype == IN_U8 || natural)))
    return (int)cudaErrorInvalidValue;
  const CrossPlan cp = make_cross_plan(levels, radix, coef, xcos, xsin);
  const int code = radix_code(cp);
  if (code < 0) return (int)cudaErrorInvalidValue;
  const int mode = natural ? MODE_NATURAL : inverse ? MODE_DIT : MODE_DIF;
  cudaStream_t st = (cudaStream_t)stream;
#define FFT_ROWS_ARGS                                                                   \
  mode, code, src_re, src_im, is, chs, channels, qstep, qim, rs, cs, re_live, im_live, \
      live_rows, live_cols, P, M, logq, lr, rs_smem, threads, out_re, out_im, out_pair, \
      minmax, lpg, cosv, sinv, gp, cp, eng, dft, st
  if (in_dtype == IN_U8) return launch_modes<uint8_t>(FFT_ROWS_ARGS);
  if (in_dtype == IN_BF16) return launch_modes<__nv_bfloat16>(FFT_ROWS_ARGS);
  return launch_modes<float>(FFT_ROWS_ARGS);
#undef FFT_ROWS_ARGS
}
#endif  // FFT_STAGE_TU, FFT_MXU_TU
