// The register-resident stage-group engine of the row FFT kernels: B1's
// transposed pass (fft_rows_t.cu), B3/B6's row-major passes (fft_rows.cu)
// and the spectral middles B2/B7/B10 (wiener_spectral.cu) run their
// radix-2 stages here.
//
// The wrapper (ops/kernels/fft_kernel.py t_plan, r_plan) cuts the S
// stages of a length q = 2^S (the pow2 tail of a row of N = R * q points)
// into groups of k <= 4 consecutive stages (11 = 4 + 4 + 3). A thread
// holds T_SLOTS = 16 complex values: 2^(4-k) items of a group, each the
// 2^k elements b = lo | hb << (s_lo + k) | j << s_lo, j < 2^k, of one
// q-block of one row, whose k stages' butterflies never leave the item.
// It runs them in registers (DIF from the top group down, DIT from the
// bottom group up, with the stage tables' twiddles: the butterflies and
// their order are the JAX _run_stages') and exchanges the values through
// shared memory once a group: S stages cost ceil(S / 4) exchanges and
// barriers, not S.
//
// Item `it` of a group lies at q-block bit field ub = (it >> ub_shift) &
// (2^(S-k) - 1), row (it >> row_shift) & (rows - 1) and cross block it >>
// (S - k + log2 rows). The wrapper picks per group the map "along" (ub
// first: neighbouring threads on neighbouring columns of one row) or
// "across" (row first).
//
// Each group takes its values from, and gives them to, one of:
//   LD_SMEM  the block's padded shared rows (one word in 32 left empty);
//   LD_ROW   device memory, element (row, b) per slot: the along map puts
//            neighbouring threads on neighbouring columns (B1's forward
//            pow2 load; B6's forward pow2 load, the top group);
//   LD_VEC   device memory, the bottom group (s_lo = 0): an item's 2^k
//            consecutive columns as 16-byte vectors (B3/B6 inverse);
//   LD_BREV  device memory, the bottom group of the natural ordering: the
//            bit-reversed input's slot hb << k | j holds column
//            brev_k(j) * 2^(S-k) + brev_{S-k}(hb), so the along map's
//            thread t takes hb = brev_{S-k}(t) and, for each j, reads
//            column brev_k(j) * 2^(S-k) + t: neighbouring threads on
//            neighbouring columns, no bit-reversal pass;
//   ST_SMEM  the shared rows;
//   ST_T     B1's transposed output (the across map: neighbouring threads
//            on neighbouring rows of one output column);
//   ST_ROW   the row-major output, element (row, b) per slot (the top
//            group, along map: B3/B6 inverse and natural, B10's last DIT
//            group);
//   ST_VEC   the row-major output, the bottom group: an item's 2^k
//            consecutive columns as 16-byte vectors (B3/B6 forward).
// ST_ROW and ST_VEC also fold the values they store into a thread's
// [min_re, max_re, min_im, max_im] when asked (B3's partials). ST_ROW,
// ST_VEC and the bottom group's shared store after LD_VEC / LD_BREV keep
// one offset an item, not one a slot (registers).
#pragma once

#include "fft_common.cuh"
#include "fft_rows_load.cuh"

#define T_SLOTS 16
#define T_MAX_GROUPS 6

// The radix-2 stage groups of one launch, DIF order (top bits first):
// group g covers stages s_lo[g] .. s_lo[g] + k[g] - 1 with the item map
// (ub_shift[g], row_shift[g]); direct_store: B1's forward pass stores
// its last group's registers straight to the transposed output
struct GroupPlan {
  int groups;
  int direct_store;
  int s_lo[T_MAX_GROUPS];
  int k[T_MAX_GROUPS];
  int ub_shift[T_MAX_GROUPS];
  int row_shift[T_MAX_GROUPS];
};

// the int32 plan array of the C entries (fft_kernel.TPlan.c_plan):
// groups, direct store, then per group s_lo, k, ub_shift, row_shift;
// false when a group is out of range or the stages do not add up to logq
__host__ inline bool read_group_plan(const int* plan, int logq, GroupPlan* gp) {
  if (plan[0] < 1 || plan[0] > T_MAX_GROUPS) return false;
  *gp = {};
  gp->groups = plan[0];
  gp->direct_store = plan[1];
  int stages = 0;
  for (int g = 0; g < gp->groups; ++g) {
    gp->s_lo[g] = plan[2 + 4 * g];
    gp->k[g] = plan[3 + 4 * g];
    gp->ub_shift[g] = plan[4 + 4 * g];
    gp->row_shift[g] = plan[5 + 4 * g];
    if (gp->k[g] < 1 || gp->k[g] > 4) return false;
    stages += gp->k[g];
  }
  return stages == logq;
}

enum { LD_SMEM = 0, LD_ROW = 1, LD_VEC = 2, LD_BREV = 3 };
enum { ST_SMEM = 0, ST_T = 1, ST_ROW = 2, ST_VEC = 3 };

// padded shared-memory column: one word in every 32 left empty
__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 5); }

// Shared pieces of a launch for the stage groups; O the output's element
// type (float32, or bfloat16 where bf16 staging stores B1's and B2's
// planes)
template <typename O>
struct TBlockOf {
  float* sre;
  float* sim;
  int rs_smem;  // padded row stride, floats
  int logq;     // S
  int lr;       // log2(rows)
  int ns;       // slot sets: rows * N / 16
  int tstride;  // width of the stage tables and of a row (N)
  const float* __restrict__ cosv;
  const float* __restrict__ sinv;
  // the output of the block's rows: ST_T the transposed (N, M) planes
  // from column m0, ST_ROW / ST_VEC the row-major planes from row m0
  O* __restrict__ out_re;
  O* __restrict__ out_im;
  int M, m0;
};
using TBlock = TBlockOf<float>;

// a value as the output stores it: float32 as it is, bfloat16 rounded to
// nearest even (as torch's .to(torch.bfloat16) and jnp's astype round);
// the stores keep their `out[i] = ` form, so the float32 instances' code
// is what it was
template <typename O>
__device__ __forceinline__ O to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a thread's [min_re, max_re, min_im, max_im] of the values it stored
__device__ __forceinline__ void fold_minmax(float (&mm)[4], float xr, float xi) {
  mm[0] = fminf(mm[0], xr);
  mm[1] = fmaxf(mm[1], xr);
  mm[2] = fminf(mm[2], xi);
  mm[3] = fmaxf(mm[3], xi);
}

// W consecutive floats from registers to 16-byte-aligned device memory
template <int W>
__device__ __forceinline__ void store_vec(float* dst, const float* x) {
  if constexpr (W == 1) {
    dst[0] = x[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int v = 0; v < W; v += 4)
      *reinterpret_cast<float4*>(dst + v) = make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
  }
}

// One stage group of width K: slot set g holds items g + jh * ns, jh <
// 2^(4-K), 2^K elements each, loaded as LD and stored as ST (above).
// BOTTOM: the group of the shortest stages (s_lo = 0), whose twiddle
// offsets are then constants shared by a thread's items; LD_VEC, LD_BREV
// and ST_VEC take it only. mm_on: fold the ST_ROW / ST_VEC values into mm.
// ADDR_AGAIN (ST_SMEM after LD_SMEM or LD_ROW): work each slot's shared
// address out again for the store instead of holding 16 of them through
// the butterflies (the spectral kernels, whose kernels keep more live).
template <int K, bool DIT, int LD, int ST, bool BOTTOM, typename T, bool ADDR_AGAIN = false,
          typename O>
__device__ __forceinline__ void stage_group(const TBlockOf<O>& tb, int s_lo_arg, int ub_shift,
                                            int row_shift, const PairLoad<T>& ld,
                                            bool mm_on, float (&mm)[4]) {
  static_assert(BOTTOM || (LD != LD_VEC && LD != LD_BREV && ST != ST_VEC),
                "vector and bit-reversed maps take the bottom group");
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
    // ST_ROW / ST_VEC: an item's output offset, -1 past the plane; a
    // bottom group loaded from device memory (LD_VEC, LD_BREV): its
    // shared offset (an item's 2^k <= 16 slots never straddle a pad word)
    int io[J];
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      const int it = g + jh * tb.ns;
      const int raw = (it >> ub_shift) & ub_mask;
      // LD_BREV: the item's q-block field is the bit reverse of the map's
      const int ub = LD != LD_BREV ? raw : lq ? (int)(__brev((unsigned)raw) >> (32 - lq)) : 0;
      const int r = (it >> row_shift) & row_mask;
      const int c = it >> (lq + tb.lr);
      lo[jh] = ub & lo_mask;
      const int base = (c << tb.logq) | lo[jh] | ((ub >> s_lo) << (s_lo + K));
      const auto row = ld.row(r);
      if constexpr (LD == LD_VEC) ld.template vec<E>(row, base, xr + jh * E, xi + jh * E);
      if constexpr (ST == ST_VEC || ST == ST_ROW)
        io[jh] = tb.m0 + r < tb.M ? r * tb.tstride + base : -1;
      if constexpr (ST == ST_SMEM && (LD == LD_VEC || LD == LD_BREV))
        io[jh] = r * tb.rs_smem + pad_idx(base);
#pragma unroll
      for (int jl = 0; jl < E; ++jl) {
        const int j = jh * E + jl;
        const int i = base | (jl << s_lo);
        const int sa = r * tb.rs_smem + pad_idx(i);
        // ST_T: a[j] is the output offset of (row, column i), -1 past the
        // plane; ST_SMEM the shared-memory slot
        if constexpr (ST == ST_SMEM && LD != LD_VEC && LD != LD_BREV && !ADDR_AGAIN) a[j] = sa;
        if constexpr (ST == ST_T) a[j] = tb.m0 + r < tb.M ? i * tb.M + r : -1;
        if constexpr (LD == LD_ROW) {
          const float2 v = ld.at(row, i);
          xr[j] = v.x;
          xi[j] = v.y;
        } else if constexpr (LD == LD_BREV) {  // column brev_k(jl) * 2^(S-k) + raw
          const float2 v = ld.at(row, raw | ((int)(__brev((unsigned)jl) >> (32 - K)) << lq));
          xr[j] = v.x;
          xi[j] = v.y;
        } else if constexpr (LD == LD_SMEM) {
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
    if constexpr (ST == ST_VEC || ST == ST_ROW) {
      constexpr int W = E < 4 ? E : 4;  // floats a vector
#pragma unroll
      for (int jh = 0; jh < J; ++jh) {
        if (io[jh] < 0) continue;
        if constexpr (ST == ST_VEC) {
#pragma unroll
          for (int v = 0; v < E; v += W) {
            store_vec<W>(tb.out_re + io[jh] + v, xr + jh * E + v);
            store_vec<W>(tb.out_im + io[jh] + v, xi + jh * E + v);
          }
        } else {
#pragma unroll
          for (int jl = 0; jl < E; ++jl) {
            tb.out_re[io[jh] + (jl << s_lo)] = to_out<O>(xr[jh * E + jl]);
            tb.out_im[io[jh] + (jl << s_lo)] = to_out<O>(xi[jh * E + jl]);
          }
        }
        if (mm_on) {
#pragma unroll
          for (int jl = 0; jl < E; ++jl) fold_minmax(mm, xr[jh * E + jl], xi[jh * E + jl]);
        }
      }
    } else if constexpr (ST == ST_SMEM && (LD == LD_VEC || LD == LD_BREV)) {
#pragma unroll
      for (int j = 0; j < T_SLOTS; ++j) {
        tb.sre[io[j / E] + j % E] = xr[j];
        tb.sim[io[j / E] + j % E] = xi[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < T_SLOTS; ++j) {
        if constexpr (ST == ST_SMEM && ADDR_AGAIN) {  // the load's address math
          const int it = g + (j / E) * tb.ns;
          const int ub = (it >> ub_shift) & ub_mask;
          const int r = (it >> row_shift) & row_mask;
          const int i = ((it >> (lq + tb.lr)) << tb.logq) | (ub & lo_mask) |
                        ((ub >> s_lo) << (s_lo + K)) | ((j % E) << s_lo);
          const int sa = r * tb.rs_smem + pad_idx(i);
          tb.sre[sa] = xr[j];
          tb.sim[sa] = xi[j];
        } else if constexpr (ST == ST_SMEM) {
          tb.sre[a[j]] = xr[j];
          tb.sim[a[j]] = xi[j];
        } else if (a[j] >= 0) {
          tb.out_re[a[j]] = to_out<O>(xr[j]);
          tb.out_im[a[j]] = to_out<O>(xi[j]);
        }
      }
    }
  }
}

// Group g of the plan, dispatched on its width and on whether it is the
// bottom group; LD / ST maps that take the bottom group only are never
// instantiated for the others
template <bool DIT, int LD, int ST, typename T, typename O>
__device__ __forceinline__ void run_group(const TBlockOf<O>& tb, const GroupPlan& gp, int g,
                                          const PairLoad<T>& ld, bool mm_on, float (&mm)[4]) {
  const int s_lo = gp.s_lo[g], us = gp.ub_shift[g], rsh = gp.row_shift[g];
  if (s_lo == 0) {
    switch (gp.k[g]) {
      case 1: stage_group<1, DIT, LD, ST, true, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
      case 2: stage_group<2, DIT, LD, ST, true, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
      case 3: stage_group<3, DIT, LD, ST, true, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
      default: stage_group<4, DIT, LD, ST, true, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
    }
    return;
  }
  if constexpr (LD != LD_VEC && LD != LD_BREV && ST != ST_VEC) {
    switch (gp.k[g]) {
      case 1: stage_group<1, DIT, LD, ST, false, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
      case 2: stage_group<2, DIT, LD, ST, false, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
      case 3: stage_group<3, DIT, LD, ST, false, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
      default: stage_group<4, DIT, LD, ST, false, T>(tb, s_lo, us, rsh, ld, mm_on, mm); break;
    }
  }
}
