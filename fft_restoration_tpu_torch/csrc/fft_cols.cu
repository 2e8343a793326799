// fft_cols: radix-2 FFT down the columns (axis -2) of (L, H, W) planes,
// its stages held in registers.
//
// Replaces fft_restoration_tpu/ops/pallas/fft_kernel.py:fft_cols_pallas
// (B11, "fftr_cols_fwd/inv"), whose transform axis sits on the TPU's
// sublanes so that fft_rows_pallas then fft_cols_pallas make a 2D FFT with
// no transpose. Unscaled, in three orderings:
//   mode 0  revorder forward: DIF, natural in, bit-reversed out
//   mode 1  revorder inverse: DIT, bit-reversed in, natural out
//   mode 2  natural (either direction): the first DIT group loads row
//           bit-reverse(h) into slot h, then DIT with the direction's
//           tables (the JAX kernel's XLA bit-reversal pass, then DIT)
// The butterflies are fft_common.cuh's, expression for expression, on the
// float64-built tables of ops/kernels/fft_kernel.py:tables(H, inverse).
//
// What bounds it on the H100: each element is read and written once, 32 B
// a complex element in and out; three 2048^2 planes move 201 MB, 60 us
// at 3.35 TB/s. The design before this one ran each of the log2(H)
// stages as a shared-memory pass with a barrier (11 at H = 2048) and sent
// the natural ordering's rows through bit-reversed shared slots: 1.6x
// torch.fft at (3, 2048, 2048), 3.8x on a tall (4096, 2048) plane.
//
// The design (the row engine's stage groups, fft_groups.cuh, turned down
// the columns; the wrapper's plan is ops/kernels/fft_kernel.py col_plan):
// - A block takes a strip of `cols` adjacent columns (a power of two) of
//   one plane, all H rows. The S = log2 H stages are cut into groups of
//   <= 4 (11 = 4 + 4 + 3). A thread holds 16 complex values: 2^(4-k)
//   items of a group of k stages, an item being the 2^k rows lo | jl <<
//   s_lo | hb << (s_lo + k) of one column, whose k stages' butterflies
//   never leave the item. Item it is column it % cols, row field it /
//   cols: neighbouring threads on neighbouring columns of one row, so a
//   warp's loads and stores are whole row segments (32 B at 8 columns).
// - Every group runs in registers; the groups exchange through shared
//   memory once each: S stages cost ceil(S / 4) - 1 exchanges and
//   barriers (2 at H = 2048 and 4096), not S.
// - Loads and stores come from registers: the first group loads device
//   memory (DIF: the top group; DIT: the bottom group, the natural
//   ordering's bit-reversed rows included), the last group stores it.
// - The strip sits in shared memory as re[H][cols] then im[H][cols],
//   row r at row r ^ ((r >> k_bottom) & (32 / cols - 1)): the rows one
//   warp spans in a group, consecutive (upper groups) or 2^k_bottom apart
//   (the bottom group), fall on distinct banks (col_row; the CPU tests
//   count the conflicts).
// - Geometry, by measurement (tools/rows_geometry.py --cols; PERF.md):
//   the widest strip that fits 128 KB (8 columns at H = 2048, one block
//   an SM) and two slot sets a thread (512 threads there). 512 threads
//   of 128 registers fill the SM's register file; 1024 threads at 64
//   registers spilled and ran 11-25% slower. At H = 4096 the strip is 4
//   columns, whose row segments are 16 B, half a 32-byte sector. A
//   ragged last strip (W not a multiple of cols) loads zeros and stores
//   nothing past W.
//
// Grid: one dimension, block b takes strip b % nstrip of plane b / nstrip.
#include "fft_common.cuh"

#define C_SLOTS 16
#define C_MAX_GROUPS 4
#define C_THREADS 512

enum { CLD_SMEM = 0, CLD_ROW = 1, CLD_BREV = 2 };
enum { CST_SMEM = 0, CST_ROW = 1 };

// the stage groups, DIF order (top first): group g runs stages s_lo[g] ..
// s_lo[g] + k[g] - 1
struct ColGroups {
  int groups;
  int s_lo[C_MAX_GROUPS];
  int k[C_MAX_GROUPS];
};

// the int32 plan array (fft_kernel.ColPlan.c_plan): groups, then per group
// s_lo and k; false unless the groups run the logh stages top down, each
// of 1-4 stages, the upper ones of 2-4
__host__ inline bool read_col_groups(const int* plan, int logh, ColGroups* gp) {
  if (plan[0] < 1 || plan[0] > C_MAX_GROUPS) return false;
  *gp = {};
  gp->groups = plan[0];
  int hi = logh;
  for (int g = 0; g < gp->groups; ++g) {
    gp->s_lo[g] = plan[1 + 2 * g];
    gp->k[g] = plan[2 + 2 * g];
    const int lo_k = g == gp->groups - 1 ? 1 : 2;
    if (gp->k[g] < lo_k || gp->k[g] > 4 || gp->s_lo[g] != hi - gp->k[g]) return false;
    hi = gp->s_lo[g];
  }
  return hi == 0;
}

// One block's strip: the planes' element (0, c0) and the shared strip
struct ColStrip {
  const float* __restrict__ src_re;
  const float* __restrict__ src_im;
  float* __restrict__ out_re;
  float* __restrict__ out_im;
  float* sre;
  float* sim;
  const float* __restrict__ cosv;
  const float* __restrict__ sinv;
  int W, logh, lc, ns, live, kb, swz;
};

// the shared row of strip row r
__device__ __forceinline__ int col_row(const ColStrip& cs, int r) {
  return r ^ ((r >> cs.kb) & cs.swz);
}

// One stage group of width K: slot set g holds items g + jh * ns, jh <
// 2^(4-K), 2^K rows each, loaded as LD and stored as ST. BOTTOM: the
// group of the shortest stages (s_lo = 0), whose twiddles are then the
// same for all of a thread's items.
template <int K, bool DIT, int LD, int ST, bool BOTTOM>
__device__ __forceinline__ void col_group(const ColStrip& cs, int s_lo_arg) {
  const int s_lo = BOTTOM ? 0 : s_lo_arg;
  constexpr int J = C_SLOTS >> K;
  constexpr int E = 1 << K;
  const int cmask = (1 << cs.lc) - 1, lo_mask = (1 << s_lo) - 1;
  const int H = 1 << cs.logh;
  for (int g = threadIdx.x; g < cs.ns; g += blockDim.x) {
    float xr[C_SLOTS], xi[C_SLOTS];
    int lo[J];
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      const int it = g + jh * cs.ns;
      const int c = it & cmask, ub = it >> cs.lc;
      lo[jh] = ub & lo_mask;
      const int rb = lo[jh] | ((ub >> s_lo) << (s_lo + K));
      if constexpr (LD == CLD_SMEM) {
#pragma unroll
        for (int jl = 0; jl < E; ++jl) {
          const int a = (col_row(cs, rb | (jl << s_lo)) << cs.lc) | c;
          xr[jh * E + jl] = cs.sre[a];
          xi[jh * E + jl] = cs.sim[a];
        }
      } else {
        // device row of slot jl: rb + jl * 2^s_lo (ROW), or (BREV, the
        // bottom group) brev(rb) + brev_K(jl) * 2^(S-K): one offset an
        // item, the slots at compile-time multiples of one row step
        const bool live = c < cs.live;
        const int r0 = LD == CLD_BREV ? (int)(__brev((unsigned)rb) >> (32 - cs.logh)) : rb;
        const int o = r0 * cs.W + c;
        const int step = cs.W << (LD == CLD_BREV ? cs.logh - K : s_lo);
#pragma unroll
        for (int jl = 0; jl < E; ++jl) {
          const int m = LD == CLD_BREV ? (int)(__brev((unsigned)jl) >> (32 - K)) : jl;
          xr[jh * E + jl] = live ? __ldg(cs.src_re + o + m * step) : 0.0f;
          xi[jh * E + jl] = live ? __ldg(cs.src_im + o + m * step) : 0.0f;
        }
      }
    }
    // the group's loads go out before its twiddle reads: no spill at 128
    // registers (the DIF top group held both at once)
    asm volatile("" ::: "memory");
#pragma unroll
    for (int bb = 0; bb < K; ++bb) {
      const int b = DIT ? bb : K - 1 - bb;  // stage s_lo + b, half 2^(s_lo+b)
      const float* wc = cs.cosv + (size_t)(s_lo + b) * H;
      const float* ws = cs.sinv + (size_t)(s_lo + b) * H;
#pragma unroll
      for (int jh = 0; jh < J; ++jh) {
#pragma unroll
        for (int jl = 0; jl < E; ++jl) {
          if (jl & (1 << b)) continue;
          const int j0 = jh * E + jl, j1 = j0 + (1 << b);
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
    for (int jh = 0; jh < J; ++jh) {  // the load's addresses, worked out again
      const int it = g + jh * cs.ns;
      const int c = it & cmask, ub = it >> cs.lc;
      const int rb = (ub & lo_mask) | ((ub >> s_lo) << (s_lo + K));
      if constexpr (ST == CST_SMEM) {
#pragma unroll
        for (int jl = 0; jl < E; ++jl) {
          const int a = (col_row(cs, rb | (jl << s_lo)) << cs.lc) | c;
          cs.sre[a] = xr[jh * E + jl];
          cs.sim[a] = xi[jh * E + jl];
        }
      } else {
        if (c >= cs.live) continue;
        const int o = rb * cs.W + c, step = cs.W << s_lo;
#pragma unroll
        for (int jl = 0; jl < E; ++jl) {
          cs.out_re[o + jl * step] = xr[jh * E + jl];
          cs.out_im[o + jl * step] = xi[jh * E + jl];
        }
      }
    }
  }
}

// Group g, dispatched on its width and on whether it is the bottom group.
// A DIT pass loads device memory in its bottom group and a DIF pass
// stores it from its bottom group only: those maps take no upper group.
template <bool DIT, int LD, int ST>
__device__ __forceinline__ void col_run(const ColStrip& cs, const ColGroups& gp, int g) {
  const int s_lo = gp.s_lo[g];
  if (s_lo == 0) {
    switch (gp.k[g]) {
      case 1: col_group<1, DIT, LD, ST, true>(cs, 0); break;
      case 2: col_group<2, DIT, LD, ST, true>(cs, 0); break;
      case 3: col_group<3, DIT, LD, ST, true>(cs, 0); break;
      default: col_group<4, DIT, LD, ST, true>(cs, 0); break;
    }
    return;
  }
  if constexpr (!(DIT && LD != CLD_SMEM) && !(!DIT && ST == CST_ROW)) {
    switch (gp.k[g]) {
      case 2: col_group<2, DIT, LD, ST, false>(cs, s_lo); break;
      case 3: col_group<3, DIT, LD, ST, false>(cs, s_lo); break;
      default: col_group<4, DIT, LD, ST, false>(cs, s_lo); break;
    }
  }
}

// MODE as above; H = 2^logh, strips of 2^lc columns, nstrip a plane
template <int MODE>
__global__ void __launch_bounds__(C_THREADS, 1)
fft_cols_kernel(const float* __restrict__ src_re, const float* __restrict__ src_im,
                float* __restrict__ out_re, float* __restrict__ out_im, int W, int logh,
                int lc, int nstrip, const float* __restrict__ cosv,
                const float* __restrict__ sinv, const __grid_constant__ ColGroups gp) {
  constexpr bool DIT = MODE != 0;
  constexpr int LD0 = MODE == 2 ? CLD_BREV : CLD_ROW;
  extern __shared__ float smem[];
  const int H = 1 << logh, cols = 1 << lc;
  const int p = blockIdx.x / nstrip;  // the plane: its base is 64-bit, offsets in it 32-bit
  const int c0 = (blockIdx.x - p * nstrip) << lc;
  const size_t base = (size_t)p * H * W + c0;
  const int swz = max(1, min(32 >> lc, H)) - 1;
  const ColStrip cs = {src_re + base, src_im + base, out_re + base, out_im + base,
                       smem, smem + (H << lc), cosv, sinv, W, logh, lc,
                       (H << lc) / C_SLOTS, min(cols, W - c0), gp.k[gp.groups - 1], swz};
  const int G = gp.groups;
  for (int i = 0; i < G; ++i) {
    const int g = DIT ? G - 1 - i : i;
    if (i) __syncthreads();
    const bool first = i == 0, last = i == G - 1;
    if (first && last)
      col_run<DIT, LD0, CST_ROW>(cs, gp, g);
    else if (first)
      col_run<DIT, LD0, CST_SMEM>(cs, gp, g);
    else if (last)
      col_run<DIT, CLD_SMEM, CST_ROW>(cs, gp, g);
    else
      col_run<DIT, CLD_SMEM, CST_SMEM>(cs, gp, g);
  }
}

template <int MODE>
static int launch_cols(const void* re, const void* im, void* out_re, void* out_im, int L,
                       int W, int logh, int lc, int threads, const void* cosv,
                       const void* sinv, const ColGroups& gp, cudaStream_t stream) {
  const size_t smem = gp.groups > 1 ? 2 * sizeof(float) * ((size_t)1 << (logh + lc)) : 0;
  cudaError_t err = allow_smem(fft_cols_kernel<MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nstrip = (W + (1 << lc) - 1) >> lc;
  if ((long long)nstrip * L > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fft_cols_kernel<MODE><<<nstrip * L, threads, smem, stream>>>(
      (const float*)re, (const float*)im, (float*)out_re, (float*)out_im, W, logh, lc, nstrip,
      (const float*)cosv, (const float*)sinv, gp);
  return (int)cudaGetLastError();
}

// L planes of (H, W), H = 2^logh >= 2, H * W < 2^31 (in-plane offsets
// are 32-bit), strips of 2^lc columns (H * 2^lc >= 16), `threads` a
// multiple of 32 up to 512; mode as above; cos/sin:
// the (logh, H) tables of the transform's direction; plan: the wrapper's
// col_plan (read_col_groups)
extern "C" int fft_cols_launch(const void* re, const void* im, void* out_re, void* out_im,
                               int L, int H, int W, int logh, int lc, int threads, int mode,
                               const void* cosv, const void* sinv, const int* plan,
                               void* stream) {
  ColGroups gp;
  if (logh < 1 || H != (1 << logh) || lc < 0 || logh + lc < 4 || lc > 5 || W < 1 ||
      (long long)H * W > 0x7fffffffLL ||
      threads < 32 || threads > C_THREADS || threads % 32 || !read_col_groups(plan, logh, &gp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FFT_COLS_ARGS re, im, out_re, out_im, L, W, logh, lc, threads, cosv, sinv, gp, s
  if (mode == 0) return launch_cols<0>(FFT_COLS_ARGS);
  if (mode == 1) return launch_cols<1>(FFT_COLS_ARGS);
  if (mode == 2) return launch_cols<2>(FFT_COLS_ARGS);
#undef FFT_COLS_ARGS
  return (int)cudaErrorInvalidValue;
}
