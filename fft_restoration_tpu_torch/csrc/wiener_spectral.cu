// The spectral middles of the 2D restore, in the transposed orientation.
//
// spectral_s_kernel<MODE, S_STORE_T, ..>: column FFT -> filter -> column
// IFFT -> transposed write. Replaces fft_restoration_tpu/ops/pallas/
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
// spectral_s_kernel<MODE_WIENER, S_STORE_NATURAL, ..>: column FFT ->
// Wiener -> natural write. Replaces wiener_spectral.py:fwd_wiener_rows_pallas
// ("fftr_fwd_wiener", B7), the middle the pipeline takes for short
// columns (hp < 512, e.g. a 256^2 stack): B2 without the DIT stages, so
// the filtered spectrum goes to device memory once and B1's inverse pass
// with transposed store (csrc/fft_rows_t.cu) finishes the middle.
// spectral_s_kernel<MODE_WIENER, S_STORE_ROWS, 1, 1>: row FFT -> Wiener ->
// row IFFT -> row-major write. Replaces wiener_spectral.py:
// wiener_spectral_rows_pallas ("fftr_spectral_mid", B10): B2's function
// with the natural store, the untransposed fused middle the JAX A/B
// harness runs (tools/perf_ab.py megakernel); on no restore path. Pow2
// rows only, as in JAX.
//
// In the transposed orientation the middle of the 2D restore works on
// each row on its own: per block of rows the DIF stages (the second
// forward pass), the filter against the matching rows of the PSF
// spectrum (H is (M, N), row m serving every plane's row m), then the
// DIT stages (the first inverse pass) and the transposed store, ready
// for the final row IFFT. The filtered 2D spectrum never goes to device
// memory (what the TPU kernel keeps in VMEM).
//
// What bounds it on the H100: B2 reads A (67 MB at 2048^2 x 2 planes) and
// H (34 MB) and writes the result (67 MB), 50 us at 3.35 TB/s; B7 at a
// batch of 64 256^2 frames (96 pairs) 101 MB, 30 us; B10 at (3, 2048,
// 2048) 235 MB, 70 us. The shared-memory
// design before this one ran each of the 2 log2(n) radix-2 stages as a
// full pass through shared memory with a barrier, one thread per
// butterfly (22 passes at n = 2048), plus a filter pass, and read the
// transposed columns from blocks of 4 rows (16-byte segments): 5.8x its
// memory floor, B7 2.6x.
//
// The design (the stage groups of fft_groups.cuh, as B1's and B3/B6's):
// - The wrapper's plan (ops/kernels/fft_kernel.py s_plan) cuts the S
//   stages into groups of k <= 4 (11 = 4 + 4 + 3); a thread holds 16
//   complex values and runs a group's butterflies in registers, one
//   shared-memory exchange a group.
// - The DIF groups run top down; the top group of a pow2 row loads its
//   items straight from device memory (LD_ROW), a smooth row loads
//   through both forward cross levels in registers (cross_item).
// - The bottom group (s_lo = 0) holds 2^k consecutive spectrum slots of
//   one row per item, so its DIF stages, the filter and (B2) its DIT
//   stages run in ONE register pass (fused_bottom): the item's H slots
//   come as 16-byte vectors of row m0 + r, one vector at a time (H never
//   doubles the register load). B7 stores the filtered items as 16-byte
//   vectors (natural (P, M, N) order).
// - B2's and B10's DIT groups run bottom up; at a pow2 length the top one
//   stores its registers straight to the output: B2's transposed one
//   (ST_T, the across map: neighbouring threads on neighbouring rows of
//   one column), B10's row-major one (ST_ROW, the along map of its top
//   DIF group: neighbouring threads on neighbouring columns). A smooth
//   row goes through both inverse cross levels in registers (cross_item)
//   as it is read for B2's transposed store; a single group (n <= 16)
//   goes through the shared rows.
//   At n = 2048: load + 2 exchanges + the fused bottom + 2 exchanges +
//   store (4 barriers).
// - Geometry: B2 blocks of 8 rows or more at n <= 2304 (32-byte column
//   segments of the transposed store), 4 at 3840-4096 (16-byte: 4 rows
//   fill 160 KB), 512 threads; B7 and B10 blocks of the rows in 32 KB (2
//   at n = 2048: no column segments to fill, so several blocks share an
//   SM), 128 threads; per group the map (along or across) and the row stride whose
//   accesses the wrapper finds cheapest in Python
//   (tests/test_torch_spectral_passes.py holds the limits). A ragged last
//   block reads zero rows and stores only the live ones.
// - __launch_bounds__(512, 1): 128 registers a thread. The upper groups
//   work their shared addresses out again at the store (stage_group's
//   ADDR_AGAIN) instead of holding 16 through the butterflies: holding
//   them spilled 4-8 bytes in some instances.
//
// Grid: one dimension, block b takes row block b / P of plane b % P: the
// planes' blocks of one row block run together, so H's rows come from L2
// after the first plane's read (the plane count is not held to
// gridDim.y's 65535).
//
// The MXU engine (engine="mxu"; B2 and B7): spectral_s_mxu_kernel<..,
// ENG> runs the outer DIF groups (stages 7 .. logq - 1), the forward group
// DFT of fft_group_dft.cuh with the filter in its epilogue (B7 storing
// there), then B2's inverse group DFT, outer DIT groups and stores.
// spectral_s_kernel keeps its parameters and code.
//
#include "fft_group_dft.cuh"

#define S_THREADS 512

enum SpectralMode { MODE_WIENER = 0, MODE_CONV = 1, MODE_CONV_CONJ = 2 };
// the output: B2's transposed (P, N, M) planes; B7's filtered spectrum in
// natural (P, M, N) order (no DIT stages); B10's row-major (P, M, N) ones
enum SpectralStore { S_STORE_T = 0, S_STORE_NATURAL = 1, S_STORE_ROWS = 2 };

// x = filter(x, h): the plain version's expressions (ops/wiener.py
// wiener_filter, spectral_product)
template <int MODE>
__device__ __forceinline__ void spectral_filter(float& xr, float& xi, float hr, float hi,
                                                float K) {
  float yr, yi;
  if constexpr (MODE == MODE_WIENER) {
    const float inv = 1.0f / (hr * hr + hi * hi + K);
    yr = (xr * hr + xi * hi) * inv;
    yi = (xi * hr - xr * hi) * inv;
  } else if constexpr (MODE == MODE_CONV) {
    yr = xr * hr - xi * hi;
    yi = xr * hi + xi * hr;
  } else {  // MODE_CONV_CONJ
    yr = xr * hr + xi * hi;
    yi = xi * hr - xr * hi;
  }
  xr = yr;
  xi = yi;
}

// W consecutive floats of the spectrum's two planes from offset o (16-byte
// aligned for W = 4, 8-byte for W = 2: the wrapper's H is aligned, and
// an item's slots start at a multiple of its width), zeros where !live
template <int W>
__device__ __forceinline__ void load_h(const float* __restrict__ h_re,
                                       const float* __restrict__ h_im, size_t o, bool live,
                                       float* hr, float* hi) {
  if (!live) {
#pragma unroll
    for (int e = 0; e < W; ++e) hr[e] = hi[e] = 0.0f;
  } else if constexpr (W == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(h_re + o));
    const float4 b = __ldg(reinterpret_cast<const float4*>(h_im + o));
    hr[0] = a.x, hr[1] = a.y, hr[2] = a.z, hr[3] = a.w;
    hi[0] = b.x, hi[1] = b.y, hi[2] = b.z, hi[3] = b.w;
  } else if constexpr (W == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(h_re + o));
    const float2 b = __ldg(reinterpret_cast<const float2*>(h_im + o));
    hr[0] = a.x, hr[1] = a.y;
    hi[0] = b.x, hi[1] = b.y;
  } else {
    hr[0] = __ldg(h_re + o);
    hi[0] = __ldg(h_im + o);
  }
}

// Stage b (half 2^b) of the bottom group over a thread's 16 slots, items
// of 2^K consecutive slots: stage_group's butterflies at s_lo = 0, whose
// twiddle offsets are the element bits below b
template <int K, bool DIT>
__device__ __forceinline__ void bottom_stage(float* xr, float* xi, int b,
                                             const float* __restrict__ wc,
                                             const float* __restrict__ ws) {
#pragma unroll
  for (int j0 = 0; j0 < T_SLOTS; ++j0) {
    const int jl = j0 & ((1 << K) - 1);
    if (jl & (1 << b)) continue;
    const int j1 = j0 + (1 << b);
    const int pos = jl & ((1 << b) - 1);
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

// The bottom stage group (s_lo = 0, width K) in one register pass over a
// thread's items: its DIF stages, the filter against H's matching slots
// of each item's row (a vector at a time, so H never doubles the register
// load), then for B2 and B10 its DIT stages with the inverse tables (the
// butterflies and their order are stage_group's). Loads from the shared
// rows; stores to them (B2, B10) or, B7, to the natural output as 16-byte
// vectors. H is the (M, N) spectrum, row m0 + r serving the block's row r.
template <int K, int MODE, int STORE>
__device__ __forceinline__ void fused_bottom(const TBlock& tb, int ub_shift, int row_shift,
                                             const float* __restrict__ cos_i,
                                             const float* __restrict__ sin_i,
                                             const float* __restrict__ h_re,
                                             const float* __restrict__ h_im, float k_reg) {
  constexpr int J = T_SLOTS >> K;
  constexpr int E = 1 << K;
  constexpr int W = E < 4 ? E : 4;  // floats a vector
  constexpr bool B7 = STORE == S_STORE_NATURAL;
  const int lq = tb.logq - K;
  const int ub_mask = (1 << lq) - 1, row_mask = (1 << tb.lr) - 1;
  // item jh of slot set g: its row r and its first slot's column
  auto row_of = [&](int g, int jh) { return ((g + jh * tb.ns) >> row_shift) & row_mask; };
  auto base_of = [&](int g, int jh) {
    const int it = g + jh * tb.ns;
    return ((it >> (lq + tb.lr)) << tb.logq) | (((it >> ub_shift) & ub_mask) << K);
  };
  for (int g = threadIdx.x; g < tb.ns; g += blockDim.x) {
    float xr[T_SLOTS], xi[T_SLOTS];
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      // an item's 2^K <= 16 slots never straddle a pad word
      const int so = row_of(g, jh) * tb.rs_smem + pad_idx(base_of(g, jh));
#pragma unroll
      for (int jl = 0; jl < E; ++jl) {
        xr[jh * E + jl] = tb.sre[so + jl];
        xi[jh * E + jl] = tb.sim[so + jl];
      }
    }
#pragma unroll
    for (int b = K - 1; b >= 0; --b)
      bottom_stage<K, false>(xr, xi, b, tb.cosv + (size_t)b * tb.tstride,
                             tb.sinv + (size_t)b * tb.tstride);
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      const int m = tb.m0 + row_of(g, jh);
      const size_t o = (size_t)m * tb.tstride + base_of(g, jh);
#pragma unroll
      for (int v = 0; v < E; v += W) {
        float hr[W], hi[W];
        load_h<W>(h_re, h_im, o + v, m < tb.M, hr, hi);
#pragma unroll
        for (int e = 0; e < W; ++e)
          spectral_filter<MODE>(xr[jh * E + v + e], xi[jh * E + v + e], hr[e], hi[e], k_reg);
      }
    }
    if constexpr (!B7) {
#pragma unroll
      for (int b = 0; b < K; ++b)
        bottom_stage<K, true>(xr, xi, b, cos_i + (size_t)b * tb.tstride,
                              sin_i + (size_t)b * tb.tstride);
    }
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      const int r = row_of(g, jh), base = base_of(g, jh);
      if constexpr (B7) {
        if (tb.m0 + r >= tb.M) continue;
        const int o = r * tb.tstride + base;
#pragma unroll
        for (int v = 0; v < E; v += W) {
          store_vec<W>(tb.out_re + o + v, xr + jh * E + v);
          store_vec<W>(tb.out_im + o + v, xi + jh * E + v);
        }
      } else {
        const int so = r * tb.rs_smem + pad_idx(base);
#pragma unroll
        for (int jl = 0; jl < E; ++jl) {
          tb.sre[so + jl] = xr[jh * E + jl];
          tb.sim[so + jl] = xi[jh * E + jl];
        }
      }
    }
  }
}

template <int MODE, int STORE>
__device__ __forceinline__ void run_bottom(const TBlock& tb, const GroupPlan& gp,
                                           const float* __restrict__ cos_i,
                                           const float* __restrict__ sin_i,
                                           const float* __restrict__ h_re,
                                           const float* __restrict__ h_im, float k_reg) {
  const int g = gp.groups - 1, us = gp.ub_shift[g], rsh = gp.row_shift[g];
#define FUSED_BOTTOM(K) fused_bottom<K, MODE, STORE>(tb, us, rsh, cos_i, sin_i, h_re, h_im, k_reg)
  switch (gp.k[g]) {
    case 1: FUSED_BOTTOM(1); break;
    case 2: FUSED_BOTTOM(2); break;
    case 3: FUSED_BOTTOM(3); break;
    default: FUSED_BOTTOM(4); break;
  }
#undef FUSED_BOTTOM
}

// Group g above the bottom one (s_lo > 0), dispatched on its width: the
// bottom group runs fused (fused_bottom), so no bottom instance of the
// stage groups is compiled here
template <bool DIT, int LD, int ST>
__device__ __forceinline__ void run_upper(const TBlock& tb, const GroupPlan& gp, int g,
                                          const PairLoad<float>& ld) {
  const int s_lo = gp.s_lo[g], us = gp.ub_shift[g], rsh = gp.row_shift[g];
  float mm[4] = {};  // no min/max in this kernel
#define UPPER_GROUP(K) \
  stage_group<K, DIT, LD, ST, false, float, ST == ST_SMEM>(tb, s_lo, us, rsh, ld, false, mm)
  switch (gp.k[g]) {
    case 1: UPPER_GROUP(1); break;
    case 2: UPPER_GROUP(2); break;
    case 3: UPPER_GROUP(3); break;
    default: UPPER_GROUP(4); break;
  }
#undef UPPER_GROUP
}

// P planes of M rows of N = R0 * R1 * 2^logq points, (P, M, N) contiguous;
// rows = 2^lr rows a block, rs_smem the padded row stride; block b takes
// rows m0 = (b / P) * rows of plane b % P. gf: the DIF groups' maps, the
// bottom one fused; gi (B2, B10): the DIT groups' maps (its bottom
// entry unread). gf.direct_store (pow2, two groups or more): the top DIF
// group loads device memory and the top DIT group stores the output from
// registers (B2 transposed, B10 row-major); otherwise both go through the
// shared rows, with the cross levels cf / ci of a smooth row.
// The MXU engine's epilogues of the forward group DFT (fft_group_dft.cuh):
// the filter against H's slot of the result's row and column (zero past
// the plane's rows, as load_h), then B2's store to the shared rows or B7's
// natural store of the live rows
template <int MODE>
struct FilterEpi {
  float* sre;
  float* sim;
  int rs;
  const float* __restrict__ h_re;
  const float* __restrict__ h_im;
  float* out_re;  // B7: the block's first output row; null for B2
  float* out_im;
  int N, M, m0;
  float k_reg;
  __device__ __forceinline__ void operator()(int r, int col, float yr, float yi) const {
    const bool live = m0 + r < M;
    const size_t o = (size_t)(m0 + r) * N + col;
    spectral_filter<MODE>(yr, yi, live ? __ldg(h_re + o) : 0.0f, live ? __ldg(h_im + o) : 0.0f,
                          k_reg);
    if (out_re == nullptr) {
      const int a = r * rs + pad_idx(col);
      sre[a] = yr;
      sim[a] = yi;
    } else if (live) {
      out_re[r * N + col] = yr;
      out_im[r * N + col] = yi;
    }
  }
};

// ENG (fft_group_dft.cuh): ENG_ROLL runs the plan's radix-2 groups, the
// bottom one fused with the filter; a tensor-core engine runs the outer
// DIF groups (stages 7 .. logq - 1), the forward group DFT with the filter
// in its epilogue (B7 storing there), the inverse group DFT (tables dft_f,
// dft_i), then the outer DIT groups and the roll instances' stores.
template <int MODE, int STORE, int R0, int R1, int ENG>
__device__ __forceinline__ void spectral_s_body(
    const float* __restrict__ a_re, const float* __restrict__ a_im,
    const float* __restrict__ h_re, const float* __restrict__ h_im, float k_reg,
    float* __restrict__ out_re, float* __restrict__ out_im, int P, int M, int logq, int lr,
    int rs_smem, const float* __restrict__ cos_f, const float* __restrict__ sin_f,
    const float* __restrict__ cos_i, const float* __restrict__ sin_i, const GroupPlan& gf,
    const GroupPlan& gi, const CrossPlan& cf, const CrossPlan& ci,
    const void* __restrict__ dft_f, const void* __restrict__ dft_i) {
  constexpr int R = R0 * R1;
  constexpr bool B7 = STORE == S_STORE_NATURAL, ROWS = STORE == S_STORE_ROWS;
  extern __shared__ float smem[];
  const int rows = 1 << lr;
  const int q = 1 << logq;
  const int N = R * q;
  const int blk = blockIdx.x / P;
  const int p = blockIdx.x - blk * P;
  const int m0 = blk * rows;
  // the output pointers are set where they are needed (fewer live registers)
  TBlock tf = {smem, smem + rows * rs_smem, rs_smem, logq, lr, (rows * N) >> 4, N,
               cos_f, sin_f, nullptr, nullptr, M, m0};
  const PairLoad<float> ld(a_re, a_im, (long long)M * N, 0, 1, 1, 0, N, 1, 0x7fffffff,
                           0x7fffffff, M, N, p, m0);
  const bool direct = R == 1 && gf.direct_store;  // the C entry refuses it for R > 1

  if (!direct) {  // load (+ both forward cross levels), item (row, b): b fastest
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
      if constexpr (R > 1) cross_item<R0, R1, false>(xr, xi, b, q, N, cf);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int a = r * rs_smem + pad_idx(b + j * q);
        tf.sre[a] = xr[j];
        tf.sim[a] = xi[j];
      }
    }
    __syncthreads();
  }
  // B7, B10: the natural (P, M, N) output from row m0; B2: the transposed
  // (P, N, M) output from column m0
  if constexpr (ENG != ENG_ROLL) {
    const size_t obase = STORE != S_STORE_T ? ((size_t)p * M + m0) * N
                                            : (size_t)p * N * M + m0;
    static_assert(STORE != S_STORE_ROWS, "B10 runs the radix-2 stages only");
    for (int g = 0; g < gf.groups; ++g) {
      if (R == 1 && g == 0 && direct)
        run_upper<false, LD_ROW, ST_SMEM>(tf, gf, g, ld);
      else
        run_upper<false, LD_SMEM, ST_SMEM>(tf, gf, g, ld);
      __syncthreads();
    }
    const int gpr = N >> DFT_LOG;
    FilterEpi<MODE> epi{tf.sre, tf.sim, rs_smem, h_re, h_im, nullptr, nullptr, N, M, m0, k_reg};
    if constexpr (B7) {
      epi.out_re = out_re + obase;
      epi.out_im = out_im + obase;
      group_dft<ENG>(tf.sre, tf.sim, rs_smem, rows, gpr, dft_f, epi);
      return;
    }
    group_dft<ENG>(tf.sre, tf.sim, rs_smem, rows, gpr, dft_f, epi);
    __syncthreads();
    group_dft<ENG>(tf.sre, tf.sim, rs_smem, rows, gpr, dft_i, SmemEpi{tf.sre, tf.sim, rs_smem});
    tf.out_re = out_re + obase;
    tf.out_im = out_im + obase;
    __syncthreads();
    TBlock ti = tf;
    ti.cosv = cos_i;
    ti.sinv = sin_i;
    for (int g = gi.groups - 1; g >= 0; --g) {
      if constexpr (R == 1) {
        if (g == 0 && direct) {
          run_upper<true, LD_SMEM, ST_T>(ti, gi, g, ld);
          return;
        }
      }
      run_upper<true, LD_SMEM, ST_SMEM>(ti, gi, g, ld);
      __syncthreads();
    }
  } else {
    for (int g = 0; g < gf.groups - 1; ++g) {
      if constexpr (R == 1) {
        if (g == 0 && direct) {
          run_upper<false, LD_ROW, ST_SMEM>(tf, gf, g, ld);
          __syncthreads();
          continue;
        }
      }
      run_upper<false, LD_SMEM, ST_SMEM>(tf, gf, g, ld);
      __syncthreads();
    }
    const size_t obase = STORE != S_STORE_T ? ((size_t)p * M + m0) * N
                                            : (size_t)p * N * M + m0;
    if constexpr (B7) {
      tf.out_re = out_re + obase;
      tf.out_im = out_im + obase;
    }
    run_bottom<MODE, STORE>(tf, gf, cos_i, sin_i, h_re, h_im, k_reg);
    if constexpr (B7) return;

    // B2, B10: the DIT groups above the bottom one, bottom up
    tf.out_re = out_re + obase;
    tf.out_im = out_im + obase;
    __syncthreads();
    TBlock ti = tf;
    ti.cosv = cos_i;
    ti.sinv = sin_i;
    for (int g = gi.groups - 2; g >= 0; --g) {
      if constexpr (R == 1) {
        if (g == 0 && direct) {
          run_upper<true, LD_SMEM, ROWS ? ST_ROW : ST_T>(ti, gi, g, ld);
          return;
        }
      }
      run_upper<true, LD_SMEM, ST_SMEM>(ti, gi, g, ld);
      __syncthreads();
    }
  }
  // (both inverse cross levels, then) the store: B2's transposed one,
  // neighbouring threads on neighbouring rows of one column; B10's
  // row-major one, neighbouring threads along a row
  for (int t = threadIdx.x; t < rows << logq; t += blockDim.x) {
    const int r = ROWS ? t >> logq : t & (rows - 1), b = ROWS ? t & (q - 1) : t >> lr;
    float xr[R], xi[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int a = r * rs_smem + pad_idx(b + j * q);
      xr[j] = tf.sre[a];
      xi[j] = tf.sim[a];
    }
    if constexpr (R > 1) cross_item<R0, R1, true>(xr, xi, b, q, N, ci);
    if (m0 + r < M) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const size_t o = ROWS ? (size_t)r * N + b + j * q : (size_t)(b + j * q) * M + r;
        tf.out_re[o] = xr[j];
        tf.out_im[o] = xi[j];
      }
    }
  }
}

template <int MODE, int STORE, int R0, int R1>
__global__ void __launch_bounds__(S_THREADS, 1)
spectral_s_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                  const float* __restrict__ h_re, const float* __restrict__ h_im, float k_reg,
                  float* __restrict__ out_re, float* __restrict__ out_im, int P, int M,
                  int logq, int lr, int rs_smem, const float* __restrict__ cos_f,
                  const float* __restrict__ sin_f, const float* __restrict__ cos_i,
                  const float* __restrict__ sin_i, const __grid_constant__ GroupPlan gf,
                  const __grid_constant__ GroupPlan gi, const __grid_constant__ CrossPlan cf,
                  const __grid_constant__ CrossPlan ci) {
  spectral_s_body<MODE, STORE, R0, R1, ENG_ROLL>(a_re, a_im, h_re, h_im, k_reg, out_re, out_im,
                                                 P, M, logq, lr, rs_smem, cos_f, sin_f, cos_i,
                                                 sin_i, gf, gi, cf, ci, nullptr, nullptr);
}

// the MXU engine's instances (ENG_BF16 or ENG_TF32X3; B2 and B7), dft_f
// and dft_i the two directions' fragment tables (B7 reads dft_f only)
template <int MODE, int STORE, int R0, int R1, int ENG>
__global__ void __launch_bounds__(S_THREADS, 1)
spectral_s_mxu_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                      const float* __restrict__ h_re, const float* __restrict__ h_im,
                      float k_reg, float* __restrict__ out_re, float* __restrict__ out_im,
                      int P, int M, int logq, int lr, int rs_smem,
                      const float* __restrict__ cos_f, const float* __restrict__ sin_f,
                      const float* __restrict__ cos_i, const float* __restrict__ sin_i,
                      const __grid_constant__ GroupPlan gf, const __grid_constant__ GroupPlan gi,
                      const __grid_constant__ CrossPlan cf, const __grid_constant__ CrossPlan ci,
                      const void* __restrict__ dft_f, const void* __restrict__ dft_i) {
  spectral_s_body<MODE, STORE, R0, R1, ENG>(a_re, a_im, h_re, h_im, k_reg, out_re, out_im, P, M,
                                            logq, lr, rs_smem, cos_f, sin_f, cos_i, sin_i, gf, gi,
                                            cf, ci, dft_f, dft_i);
}

// the arguments of one launch, as the C entries pass them on
#define SPECTRAL_LAUNCH_PARAMS                                                              \
  const void *a_re, const void *a_im, const void *h_re, const void *h_im, float k_reg,     \
      void *out_re, void *out_im, int P, int M, int logq, int lr, int rs_smem, int threads, \
      const void *cos_f, const void *sin_f, const void *cos_i, const void *sin_i,          \
      const GroupPlan &gf, const GroupPlan &gi, const CrossPlan &cf, const CrossPlan &ci,  \
      const void *dft_f, const void *dft_i, cudaStream_t stream
#define SPECTRAL_KERNEL_ARGS                                                                 \
  nblk * P, threads, smem, stream, (const float*)a_re, (const float*)a_im,                  \
      (const float*)h_re, (const float*)h_im, k_reg, (float*)out_re, (float*)out_im, P, M,  \
      logq, lr, rs_smem, (const float*)cos_f, (const float*)sin_f, (const float*)cos_i,     \
      (const float*)sin_i, gf, gi, cf, ci

// The launch of an MXU instance (ENG_BF16 or ENG_TF32X3; B2 and B7),
// built in translation units of their own as fft_rows_t.cu's
template <int MODE, int STORE, int R0, int R1, int ENG>
int launch_s_mxu(SPECTRAL_LAUNCH_PARAMS);

#ifdef FFT_MXU_TU
template <int MODE, int STORE, int R0, int R1, int ENG>
int launch_s_mxu(SPECTRAL_LAUNCH_PARAMS) {
  const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
  const int rows = 1 << lr;
  const int nblk = (M + rows - 1) / rows;
  if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return start_kernel(spectral_s_mxu_kernel<MODE, STORE, R0, R1, ENG>, SPECTRAL_KERNEL_ARGS,
                      dft_f, dft_i);
}

#define SPECTRAL_MXU(MODE, STORE)                                                     \
  template int launch_s_mxu<MODE, STORE, 1, 1, FFT_MXU_TU>(SPECTRAL_LAUNCH_PARAMS);   \
  template int launch_s_mxu<MODE, STORE, 3, 1, FFT_MXU_TU>(SPECTRAL_LAUNCH_PARAMS);   \
  template int launch_s_mxu<MODE, STORE, 5, 1, FFT_MXU_TU>(SPECTRAL_LAUNCH_PARAMS);   \
  template int launch_s_mxu<MODE, STORE, 3, 3, FFT_MXU_TU>(SPECTRAL_LAUNCH_PARAMS);   \
  template int launch_s_mxu<MODE, STORE, 3, 5, FFT_MXU_TU>(SPECTRAL_LAUNCH_PARAMS);
SPECTRAL_MXU(MODE_WIENER, S_STORE_T)
SPECTRAL_MXU(MODE_CONV, S_STORE_T)
SPECTRAL_MXU(MODE_CONV_CONJ, S_STORE_T)
SPECTRAL_MXU(MODE_WIENER, S_STORE_NATURAL)
#undef SPECTRAL_MXU
#else

template <int MODE, int STORE, int R0, int R1>
static int launch_s(const void* a_re, const void* a_im, const void* h_re, const void* h_im,
                    float k_reg, void* out_re, void* out_im, int P, int M, int logq, int lr,
                    int rs_smem, int threads, const void* cos_f, const void* sin_f,
                    const void* cos_i, const void* sin_i, const GroupPlan& gf,
                    const GroupPlan& gi, const CrossPlan& cf, const CrossPlan& ci,
                    int eng, const void* dft_f, const void* dft_i, cudaStream_t stream) {
#define SPECTRAL_MXU_ARGS                                                                  \
  a_re, a_im, h_re, h_im, k_reg, out_re, out_im, P, M, logq, lr, rs_smem, threads, cos_f, \
      sin_f, cos_i, sin_i, gf, gi, cf, ci, dft_f, dft_i, stream
  if (eng == ENG_ROLL) {
    const size_t smem = 2 * sizeof(float) * ((size_t)rs_smem << lr);
    const int rows = 1 << lr;
    const int nblk = (M + rows - 1) / rows;
    if ((long long)nblk * P > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    return start_kernel(spectral_s_kernel<MODE, STORE, R0, R1>, SPECTRAL_KERNEL_ARGS);
  }
  if constexpr (STORE == S_STORE_ROWS) {  // B10: roll only
    return (int)cudaErrorInvalidValue;
  } else {
    switch (eng) {
      case ENG_BF16: return launch_s_mxu<MODE, STORE, R0, R1, ENG_BF16>(SPECTRAL_MXU_ARGS);
      case ENG_TF32X3: return launch_s_mxu<MODE, STORE, R0, R1, ENG_TF32X3>(SPECTRAL_MXU_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef SPECTRAL_MXU_ARGS
}

template <int MODE, int STORE>
static int launch_radices(const void* a_re, const void* a_im, const void* h_re,
                          const void* h_im, float k_reg, void* out_re, void* out_im, int P,
                          int M, int logq, int lr, int rs_smem, int threads, const void* cos_f,
                          const void* sin_f, const void* cos_i, const void* sin_i,
                          const GroupPlan& gf, const GroupPlan& gi, const CrossPlan& cf,
                          const CrossPlan& ci, int eng, const void* dft_f, const void* dft_i,
                          cudaStream_t stream) {
#define SPECTRAL_LAUNCH(R0, R1)                                                             \
  launch_s<MODE, STORE, R0, R1>(a_re, a_im, h_re, h_im, k_reg, out_re, out_im, P, M, logq, lr, \
                             rs_smem, threads, cos_f, sin_f, cos_i, sin_i, gf, gi, cf, ci,  \
                             eng, dft_f, dft_i, stream)
  switch (radix_code(cf)) {
    case 0: return SPECTRAL_LAUNCH(1, 1);
    case 1: return SPECTRAL_LAUNCH(3, 1);
    case 2: return SPECTRAL_LAUNCH(5, 1);
    case 3: return SPECTRAL_LAUNCH(3, 3);
    case 4: return SPECTRAL_LAUNCH(3, 5);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_LAUNCH
}

// the two directions' cross levels (levels 0 for a pow2 N; see
// make_cross_plan), as the C entries receive them
#define CROSS_ARGS(d)                                                    \
  int levels_##d, const int *radix_##d, const float *coef_##d,           \
      const void *xcos_##d, const void *xsin_##d
#define CROSS_PLAN(d) \
  make_cross_plan(levels_##d, radix_##d, coef_##d, xcos_##d, xsin_##d)

static bool bad_levels(int levels) {
  return levels < 0 || levels > MAX_CROSS_LEVELS;
}

// The plan arrays of one launch (fft_kernel.TPlan.c_plan; B2's and B10's
// DIT maps in plan_i, B7 none) and its geometry, checked: false when they do not
// describe logq stages (the outer stages 7 .. logq - 1 for a tensor-core
// engine, mxu), the two plans' groups differ, a thread's 16 slots
// are not all live (rows * q >= 16), or the direct maps meet a smooth row
// or a single group (no group, mxu)
static bool read_plans(const int* plan_f, const int* plan_i, int logq, int lr, int threads,
                       int levels, GroupPlan* gf, GroupPlan* gi, bool mxu = false) {
  auto read = [&](const int* plan, GroupPlan* gp) {
    return mxu ? read_mxu_plan(plan, logq, gp) : read_group_plan(plan, logq, gp);
  };
  if (!read(plan_f, gf) || logq + lr < 4 || threads < 32 || threads > S_THREADS || threads % 32)
    return false;
  if (gf->direct_store && (levels > 0 || gf->groups < (mxu ? 1 : 2))) return false;
  if (plan_i == nullptr) {
    *gi = *gf;
    return true;
  }
  if (!read(plan_i, gi) || gi->groups != gf->groups) return false;
  for (int g = 0; g < gf->groups; ++g)
    if (gi->s_lo[g] != gf->s_lo[g] || gi->k[g] != gf->k[g]) return false;
  return true;
}

template <int MODE, int STORE>
static int launch_entry(const void* a_re, const void* a_im, const void* h_re, const void* h_im,
                        float k_reg, void* out_re, void* out_im, int P, int M, int logq, int lr,
                        int rs_smem, int threads, const void* cos_f, const void* sin_f,
                        const void* cos_i, const void* sin_i, const int* plan_f,
                        const int* plan_i, const CrossPlan& cf, const CrossPlan& ci,
                        int eng, const void* dft_f, const void* dft_i, void* stream) {
  GroupPlan gf, gi;
  const bool mxu = eng != ENG_ROLL;
  if (!read_plans(plan_f, plan_i, logq, lr, threads, cf.levels, &gf, &gi, mxu) ||
      radix_code(cf) < 0 || radix_code(ci) != radix_code(cf) ||
      (mxu && (dft_f == nullptr || (STORE != S_STORE_NATURAL && dft_i == nullptr))))
    return (int)cudaErrorInvalidValue;
  return launch_radices<MODE, STORE>(a_re, a_im, h_re, h_im, k_reg, out_re, out_im, P, M, logq,
                                  lr, rs_smem, threads, cos_f, sin_f, cos_i, sin_i, gf, gi, cf,
                                  ci, eng, dft_f, dft_i, (cudaStream_t)stream);
}

// B2 'wiener'. logq = S; lr = log2(rows); rs_smem the padded row stride;
// threads a multiple of 32 up to 512; plan_f / plan_i: the wrapper's
// s_plan (its DIF and DIT maps); the two directions' cross levels; eng:
// ENG_ROLL, or a tensor-core engine (fft_group_dft.cuh) with the
// outer-stage plans and dft_f / dft_i the two directions' fragment tables
extern "C" int wiener_spectral_t_launch(const void* a_re, const void* a_im,
                                        const void* h_re, const void* h_im, float K,
                                        void* out_re, void* out_im, int P, int M, int logq,
                                        int lr, int rs_smem, int threads, const void* cos_f,
                                        const void* sin_f, const void* cos_i,
                                        const void* sin_i, const int* plan_f,
                                        const int* plan_i, CROSS_ARGS(f), CROSS_ARGS(i),
                                        int eng, const void* dft_f, const void* dft_i,
                                        void* stream) {
  if (bad_levels(levels_f) || bad_levels(levels_i)) return (int)cudaErrorInvalidValue;
  return launch_entry<MODE_WIENER, S_STORE_T>(a_re, a_im, h_re, h_im, K, out_re, out_im, P, M,
                                          logq, lr, rs_smem, threads, cos_f, sin_f, cos_i,
                                          sin_i, plan_f, plan_i, CROSS_PLAN(f), CROSS_PLAN(i),
                                          eng, dft_f, dft_i, stream);
}

// B2 'conv'; conj != 0: F = G * conj(H) (the mirrored PSF's convolution)
extern "C" int spectral_conv_t_launch(const void* a_re, const void* a_im, const void* h_re,
                                      const void* h_im, int conj, void* out_re, void* out_im,
                                      int P, int M, int logq, int lr, int rs_smem, int threads,
                                      const void* cos_f, const void* sin_f, const void* cos_i,
                                      const void* sin_i, const int* plan_f, const int* plan_i,
                                      CROSS_ARGS(f), CROSS_ARGS(i), int eng, const void* dft_f,
                                      const void* dft_i, void* stream) {
  if (bad_levels(levels_f) || bad_levels(levels_i)) return (int)cudaErrorInvalidValue;
  const CrossPlan cf = CROSS_PLAN(f), ci = CROSS_PLAN(i);
  if (conj)
    return launch_entry<MODE_CONV_CONJ, S_STORE_T>(a_re, a_im, h_re, h_im, 0.0f, out_re, out_im, P,
                                               M, logq, lr, rs_smem, threads, cos_f, sin_f,
                                               cos_i, sin_i, plan_f, plan_i, cf, ci, eng, dft_f,
                                               dft_i, stream);
  return launch_entry<MODE_CONV, S_STORE_T>(a_re, a_im, h_re, h_im, 0.0f, out_re, out_im, P, M,
                                        logq, lr, rs_smem, threads, cos_f, sin_f, cos_i, sin_i,
                                        plan_f, plan_i, cf, ci, eng, dft_f, dft_i, stream);
}

// B7: the forward cross levels and tables only (the inverse ones unread)
extern "C" int fwd_wiener_rows_launch(const void* a_re, const void* a_im, const void* h_re,
                                      const void* h_im, float K, void* out_re, void* out_im,
                                      int P, int M, int logq, int lr, int rs_smem, int threads,
                                      const void* cos_f, const void* sin_f, const int* plan_f,
                                      CROSS_ARGS(f), int eng, const void* dft_f, void* stream) {
  if (bad_levels(levels_f)) return (int)cudaErrorInvalidValue;
  const CrossPlan cf = CROSS_PLAN(f);
  return launch_entry<MODE_WIENER, S_STORE_NATURAL>(a_re, a_im, h_re, h_im, K, out_re, out_im, P, M, logq,
                                         lr, rs_smem, threads, cos_f, sin_f, nullptr, nullptr,
                                         plan_f, nullptr, cf, cf, eng, dft_f, nullptr, stream);
}

// B10 (wiener_spectral_rows): the row-major store, pow2 rows only (no
// cross levels), 'wiener' mode; arguments as B2's, plan_i the DIT maps
extern "C" int wiener_spectral_rows_launch(const void* a_re, const void* a_im,
                                           const void* h_re, const void* h_im, float K,
                                           void* out_re, void* out_im, int P, int M, int logq,
                                           int lr, int rs_smem, int threads, const void* cos_f,
                                           const void* sin_f, const void* cos_i,
                                           const void* sin_i, const int* plan_f,
                                           const int* plan_i, void* stream) {
  GroupPlan gf, gi;
  if (!read_plans(plan_f, plan_i, logq, lr, threads, 0, &gf, &gi))
    return (int)cudaErrorInvalidValue;
  const CrossPlan none = make_cross_plan(0, nullptr, nullptr, nullptr, nullptr);
  return launch_s<MODE_WIENER, S_STORE_ROWS, 1, 1>(
      a_re, a_im, h_re, h_im, K, out_re, out_im, P, M, logq, lr, rs_smem, threads, cos_f, sin_f,
      cos_i, sin_i, gf, gi, none, none, ENG_ROLL, nullptr, nullptr, (cudaStream_t)stream);
}
#endif  // FFT_MXU_TU
