// The group DFT of the MXU instances of B1, B3/B6 (fft_rows_t.cu,
// fft_rows.cu: group_dft_res) and B2/B7 (wiener_spectral.cu:
// group_dft_sym, at the end), redesigned for Hopper: its tables resident
// in shared memory, copied once a block by the TMA.
//
// The design before (fft_group_dft.cuh group_dft, which only the forward
// B1 and B6 passes and B7 at 'default' still run, faster there on an
// H100): every warp task of 8 groups reads the whole DFT-128 operand with
// __ldg, 96 KB ('default') or 192 KB ('highest') of tables for 8 KB of
// data: 805 MB / 1.61 GB for a 2048^2 frame's B1 pass against its 80 MB
// of planes, through an L1 that holds the 'default' tables only in part
// and from L2 for the rest (2.2-3.5x torch.fft at 'default', 5.7-8.1x at
// 'highest' on an H100).
//
// The design:
// - One direction's tables live in the block's shared memory, in front
//   of its rows. Thread 0 starts one bulk asynchronous copy
//   (cp.async.bulk, the TMA's 1-D form, in 16 KB pieces completing on one
//   mbarrier) as the block starts, so it overlaps the first row block's
//   load and outer stages; the group DFT waits on the mbarrier's first
//   phase. The kernels keep one persistent block an SM that walks over
//   the row blocks (start_persistent), so the tables leave L2 once a
//   block: 132 x 96 KB = 12.7 MB a launch at 'default' on an H100.
// - 'default' (ENG_BF16) keeps the arithmetic of group_dft: the three
//   real products m1 = xr Wc, m2 = xi Ws, m3 = (xr + xi)(Wc + Ws) with
//   xr, xi and xr + xi rounded to bf16 as they are packed, the same bf16
//   fragment tables (fft_kernel.dft_fragments, 96 KB) and mma.sync
//   m16n8k16, so its twin is still fft_kernel.group_dft_plain.
// - 'highest' (ENG_TF32X3) takes the DFT matrix's conjugate symmetry.
//   With c, s the columns k = 0 .. 79 (5 bin tiles) of the float64-built
//   _dft_planes_np(128) planes (fft_kernel.dft_sym_fragments_np, 80 KB
//   of float32), c + s and c - s summed in float32 as they load, and xs = xr
//   + xi, four real products m1 = xr c, m2 = xi s, m3 = xs (c + s), m4 =
//   xs (c - s) (3xTF32 on mma.sync m16n8k8) give the twin's three-product
//   form for bin k and for its mirror 128 - k (c and -s there):
//     Y[k]       = (m1 - m2) + i (m3 - m1 - m2),  k = 0 .. 64,
//     Y[128 - k] = (m1 + m2) + i (m4 - m1 + m2),  k = 1 .. 63
//   (columns 65 .. 79 are computed and dropped). The twin's columns
//   128 - k are within an ulp of these columns' mirror images, and the
//   imaginary part keeps the twin's difference of large products (on a
//   spectrum with a large DC the twin's own float32 rounding is what sets
//   the small imaginary values), so the kernel stays within float32's
//   accuracy of the float32 twin.
// - A warp task is 8 groups (the mma's N) and all their bins, as in
//   group_dft: the groups' values stay in registers for the whole task
//   (48 registers of bf16 pairs, 64 of float32) and the results overwrite
//   the groups' own shared slots with no block barrier; each A fragment is
//   one conflict-free 16-byte shared load a lane ('highest' reads c and s
//   once in each of two passes over the k steps, m1 and m2 then m3 and m4:
//   fewer values live at once). Table bytes a group: 12 KB / 20 KB from
//   shared memory, 96 KB / 80 KB from L2 a block.
// - The tables are laid out in chunks of one bin tile and k step (1.5 KB
//   at 'default', 1 KB at 'highest'). Where all of them do not fit beside
//   the rows (8 rows of 2048 points, 135 KB, which B1's transposed store
//   needs for 32-byte column segments; 4 of 4096; one row of 16384), the
//   first chunks that fit are resident (62 of 64 at 'default') and the
//   last are read from global memory, as group_dft reads its tables: 3 KB
//   a task, which the L1 keeps (fft_kernel.dft_res_chunks counts them
//   beside the plan; 'highest', 80 KB, always fits). The bin tiles whose
//   chunks are all resident read them with plain shared loads.
#pragma once

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "fft_group_dft.cuh"

#define DFT_SYM_TILES 5    // 'highest' bin tiles: columns 0 .. 79 (0 .. 64 used)
#define DFT_RES_BAR 16     // the mbarrier's slot after the tables (keeps the rows 16-byte aligned)
#define DFT_RES_CHUNK 16384  // bytes a bulk copy
// B2's and B7's table (both directions, both precisions): 4 bin tiles x 8
// k steps x 4 bf16 tables or x 16 k steps x 2 float32 tables, of 512 bytes
#define DFT_HALF_TILES 4  // columns 0 .. 63; bin 64 from sums (sym_bin64)
#define DFT_HALF_BYTES (DFT_HALF_TILES * 16 * 2 * 32 * 16)

// one direction's tables (fft_kernel.DFT_RES_BYTES): [bin tile][k
// step][table][lane][16 bytes], chunks of one bin tile and k step: 8 x 8
// of 1.5 KB ('default'), 5 x 16 of 1 KB ('highest')
__host__ __device__ constexpr int dft_res_chunks_all(int eng) {
  return eng == ENG_BF16 ? 8 * 8 : DFT_SYM_TILES * 16;
}
__host__ __device__ constexpr int dft_res_chunk_bytes(int eng) {
  return eng == ENG_BF16 ? 3 * 32 * 16 : 2 * 32 * 16;
}

// One direction's tables as a launch takes them: the whole tables in
// global memory and the count of their first chunks that the kernel
// copies into shared memory (fft_kernel.dft_res_chunks works it out
// beside the plan)
struct DftRes {
  const void* tab;
  int chunks;
};

// the launch's bound check of a DftRes: the tables there, at most all of
// their chunks, all of them at 'highest' (the kernel reads no 'highest'
// table from global memory); its shared memory, the chunks' bytes, the
// mbarrier's slot and `rows_bytes`, or -1
template <int ENG>
__host__ inline long long dft_res_smem(const DftRes& d, size_t rows_bytes) {
  const int all = dft_res_chunks_all(ENG);
  if (d.tab == nullptr || d.chunks < 0 || d.chunks > all || (ENG != ENG_BF16 && d.chunks != all))
    return -1;
  return (long long)d.chunks * dft_res_chunk_bytes(ENG) + DFT_RES_BAR + (long long)rows_bytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0: initialise the mbarrier at `bar` and start the bulk copy of
// `bytes` (a multiple of 16) of tables from global `src` (16-byte
// aligned) to shared `dst`. The waiters pass a block barrier first (a
// block whose row blocks all lie past the live rows meets none: thread 0
// alone waits before it leaves).
__device__ __forceinline__ void dft_tables_start(void* dst, const void* src, int bytes,
                                                 uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  for (int o = 0; o < bytes; o += DFT_RES_CHUNK) {
    const int n = min(DFT_RES_CHUNK, bytes - o);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(static_cast<char*>(dst) + o)), "l"(static_cast<const char*>(src) + o),
        "r"(n), "r"(b)
        : "memory");
  }
}

// Wait for the tables: the mbarrier's first phase (at once after it)
__device__ __forceinline__ void dft_tables_wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
}

// d += a b in 3xTF32 from split operands: the small products first
__device__ __forceinline__ void mma_3xtf32_split(float (&d)[4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4], uint32_t bh0,
                                                 uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void split_tf32x4(const float4& w, uint32_t (&h)[4], uint32_t (&l)[4]) {
  split_tf32(w.x, h[0], l[0]);
  split_tf32(w.y, h[1], l[1]);
  split_tf32(w.z, h[2], l[2]);
  split_tf32(w.w, h[3], l[3]);
}

// A warp task's groups (group_dft's mapping): the lane's B column, group
// first + g at shared offset so + pad_idx(pos) (row irow, first column
// icol), and its two D columns, groups first + 2t + e, e < 2 (row, first
// column)
struct DftTask {
  bool in_ok;
  int so, irow, icol;
  int orow[2], ocol[2];
  bool out_ok[2];
  __device__ __forceinline__ DftTask(int first, int groups, int gpr, int rs, int g, int t) {
    const int gin = first + g;
    in_ok = gin < groups;
    irow = in_ok ? gin / gpr : 0;
    const int c = in_ok ? gin - irow * gpr : 0;
    so = irow * rs + c * (DFT_N + DFT_N / 32);
    icol = c * DFT_N;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int go = first + 2 * t + e;
      out_ok[e] = go < groups;
      orow[e] = out_ok[e] ? go / gpr : 0;
      ocol[e] = (go - orow[e] * gpr) * DFT_N;
    }
  }
};

// The symmetric form's products of bin tile mt at 'highest' (3xTF32):
// m1 = xr c, m2 = xi s, m3 = xs (c + s), m4 = xs (c - s), xs = xr + xi,
// with c, s the tables' tile (A, the lane's first fragment; c + s and c - s
// summed in float32 as they load), in two passes over the k steps (fewer
// values live at once)
__device__ __forceinline__ void sym_products_tf32(const float (&xr)[16][2],
                                                  const float (&xi)[16][2], const float4* A,
                                                  int mt, float (&m1)[4], float (&m2)[4],
                                                  float (&m3)[4], float (&m4)[4]) {
#pragma unroll
  for (int kt = 0; kt < 16; ++kt) {
    uint32_t wh[4], wl[4], bh[2], bl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) split_tf32(xr[kt][h], bh[h], bl[h]);
    split_tf32x4(A[(mt * 16 + kt) * 2 * 32], wh, wl);
    mma_3xtf32_split(m1, wh, wl, bh[0], bh[1], bl[0], bl[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) split_tf32(xi[kt][h], bh[h], bl[h]);
    split_tf32x4(A[(mt * 16 + kt) * 2 * 32 + 32], wh, wl);
    mma_3xtf32_split(m2, wh, wl, bh[0], bh[1], bl[0], bl[1]);
  }
#pragma unroll
  for (int kt = 0; kt < 16; ++kt) {
    const float4 c = A[(mt * 16 + kt) * 2 * 32], sn = A[(mt * 16 + kt) * 2 * 32 + 32];
    uint32_t wh[4], wl[4], bh[2], bl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) split_tf32(xr[kt][h] + xi[kt][h], bh[h], bl[h]);
    split_tf32x4(make_float4(c.x + sn.x, c.y + sn.y, c.z + sn.z, c.w + sn.w), wh, wl);
    mma_3xtf32_split(m3, wh, wl, bh[0], bh[1], bl[0], bl[1]);
    split_tf32x4(make_float4(c.x - sn.x, c.y - sn.y, c.z - sn.z, c.w - sn.w), wh, wl);
    mma_3xtf32_split(m4, wh, wl, bh[0], bh[1], bl[0], bl[1]);
  }
}

// The symmetric form's results of bin tile mt: d[e] is column k = 16 mt +
// g + 8 (e >> 1) of group 2t + (e & 1); with the tables' s (the forward
// direction's) P = (m1 - m2, m3 - m1 - m2) is the three-product form at bin
// k and Q = (m1 + m2, m4 - m1 + m2) at its mirror 128 - k (c and -s
// there). The inverse direction's s is -s, so `inv` swaps them: bin k
// takes Q, 128 - k takes P. Bins k <= 64 and mirrors of 0 < k < 64 (the
// row kernels' fifth tile, columns 64 .. 79, drops 65 .. 79).
template <typename Epi>
__device__ __forceinline__ void sym_results(const float (&m1)[4], const float (&m2)[4],
                                            const float (&m3)[4], const float (&m4)[4], int mt,
                                            int g, bool inv, const DftTask& tk, const Epi& epi) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = 16 * mt + g + 8 * (e >> 1);
    if (!tk.out_ok[e & 1]) continue;
    if (k <= DFT_N / 2)
      epi(tk.orow[e & 1], tk.ocol[e & 1] + k, inv ? m1[e] + m2[e] : m1[e] - m2[e],
          inv ? m4[e] - m1[e] + m2[e] : m3[e] - m1[e] - m2[e]);
    if (k > 0 && k < DFT_N / 2)
      epi(tk.orow[e & 1], tk.ocol[e & 1] + DFT_N - k, inv ? m1[e] - m2[e] : m1[e] + m2[e],
          inv ? m3[e] - m1[e] - m2[e] : m4[e] - m1[e] + m2[e]);
  }
}

// Bin 64 of the lane's B column's group, where c = cos(pi l) = (-1)^l and s
// = -sin(pi l) is a float64 zero (|s| < 2e-14; c + s and c - s round to c
// at either precision): m1 = sum_l (-1)^l xr_l and m3 = sum_l (-1)^l xs_l
// from the lane's partial sums r1 and r3 of its positions' signed values,
// summed over the group's 4 lanes (t); (m1, m3 - m1) in either direction,
// the twin's m2 (~1e-14 of the values) dropped; the lane with t = 0
// hands it to epi
template <typename Epi>
__device__ __forceinline__ void sym_bin64(float r1, float r3, int t, const DftTask& tk,
                                          const Epi& epi) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    r1 += __shfl_xor_sync(0xffffffffu, r1, o);
    r3 += __shfl_xor_sync(0xffffffffu, r3, o);
  }
  if (t == 0 && tk.in_ok) epi(tk.irow, tk.icol + DFT_N / 2, r1, r3 - r1);
}

// The group DFT of every 128-point group of the block's rows (rows x gpr
// groups, as group_dft lays them out) with the first `res` chunks of the
// tables resident at `tab` in shared memory (dft_tables_wait first) and
// the rest ('default' only) read from gtab, the whole tables in global
// memory; each result handed to epi(r, column, yr, yi). A warp task is 8
// groups and all their bins, the groups' values in the warp's registers
// before it writes a result into their own shared slots: no block
// barrier. The caller puts one before (the groups' values in shared
// memory) and after.
template <int ENG, typename Epi>
__device__ __forceinline__ void group_dft_res(const float* sre, const float* sim, int rs, int rows,
                                              int gpr, const void* tab, int res,
                                              const void* __restrict__ gtab, const Epi& epi) {
  static_assert(ENG == ENG_BF16 || ENG == ENG_TF32X3, "a tensor-core engine");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = rows * gpr;
  for (int task = threadIdx.x >> 5; task * DFT_TASK < groups; task += blockDim.x >> 5) {
    const DftTask tk(task * DFT_TASK, groups, gpr, rs, g, t);
    const bool in_ok = tk.in_ok;
    const int so = tk.so;
    if constexpr (ENG == ENG_BF16) {
      // b0: positions 16 kt + 2t, +1; b1: 16 kt + 2t + 8, +9
      uint32_t br[8][2], bi[8][2], bs[8][2];
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 16 * kt + 2 * t + 8 * h;
          const float r0 = in_ok ? sre[so + pad_idx(p)] : 0.0f;
          const float r1 = in_ok ? sre[so + pad_idx(p + 1)] : 0.0f;
          const float i0 = in_ok ? sim[so + pad_idx(p)] : 0.0f;
          const float i1 = in_ok ? sim[so + pad_idx(p + 1)] : 0.0f;
          br[kt][h] = pack_bf16(r0, r1);
          bi[kt][h] = pack_bf16(i0, i1);
          bs[kt][h] = pack_bf16(r0 + i0, r1 + i1);
        }
      }
      __syncwarp();
      // chunk c = mt * 8 + kt of the tables: shared loads where all of the
      // bin tile's chunks are resident (every tile but the last beside 8
      // rows of 2048), else each chunk from shared memory below res and
      // from global memory (the L1) past it
      const uint4* As = reinterpret_cast<const uint4*>(tab) + lane;
      const uint4* Ag = reinterpret_cast<const uint4*>(gtab) + lane;
#pragma unroll 1
      for (int mt = 0; mt < 8; ++mt) {
        float m1[4] = {}, m2[4] = {}, m3[4] = {};
        if (8 * mt + 8 <= res) {
#pragma unroll
          for (int kt = 0; kt < 8; ++kt) {
            const uint4* a = As + (mt * 8 + kt) * 3 * 32;
            mma_bf16(m1, a[0], br[kt][0], br[kt][1]);
            mma_bf16(m2, a[32], bi[kt][0], bi[kt][1]);
            mma_bf16(m3, a[64], bs[kt][0], bs[kt][1]);
          }
        } else {
#pragma unroll
          for (int kt = 0; kt < 8; ++kt) {
            const int c = mt * 8 + kt;
            uint4 w[3];
            if (c < res) {
#pragma unroll
              for (int j = 0; j < 3; ++j) w[j] = As[(c * 3 + j) * 32];
            } else {
#pragma unroll
              for (int j = 0; j < 3; ++j) w[j] = __ldg(Ag + (c * 3 + j) * 32);
            }
            mma_bf16(m1, w[0], br[kt][0], br[kt][1]);
            mma_bf16(m2, w[1], bi[kt][0], bi[kt][1]);
            mma_bf16(m3, w[2], bs[kt][0], bs[kt][1]);
          }
        }
        // d[e]: bin 16 mt + g + 8 (e >> 1) of group 2t + (e & 1)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tk.out_ok[e & 1])
            epi(tk.orow[e & 1], tk.ocol[e & 1] + 16 * mt + g + 8 * (e >> 1), m1[e] - m2[e],
                m3[e] - m1[e] - m2[e]);
      }
    } else {
      // b0: position 8 kt + t; b1: 8 kt + t + 4
      float xr[16][2], xi[16][2];
#pragma unroll
      for (int kt = 0; kt < 16; ++kt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 8 * kt + t + 4 * h;
          xr[kt][h] = in_ok ? sre[so + pad_idx(p)] : 0.0f;
          xi[kt][h] = in_ok ? sim[so + pad_idx(p)] : 0.0f;
        }
      }
      __syncwarp();
      const float4* A = reinterpret_cast<const float4*>(tab) + lane;
#pragma unroll 1
      for (int mt = 0; mt < DFT_SYM_TILES; ++mt) {
        float m1[4] = {}, m2[4] = {}, m3[4] = {}, m4[4] = {};
        sym_products_tf32(xr, xi, A, mt, m1, m2, m3, m4);
        sym_results(m1, m2, m3, m4, mt, g, false, tk, epi);
      }
    }
  }
}

// B2's and B7's group DFT (wiener_spectral.cu spectral_s_mxu_kernel): one
// table, resident in shared memory at `tab`, serves both directions
// (fft_kernel.dft_half_tables, DFT_HALF_BYTES = 64 KB): the forward
// direction's c, s over columns 0 .. 63 in the symmetric form
// (sym_results: bins 0 .. 63 and the mirrors 65 .. 127), as [bin tile][k
// step][table][lane] fragments, and bin 64 from plain sums (sym_bin64).
// 'highest' (ENG_TF32X3): the float32 c, s of group_dft_res (its first 4
// tiles), c + s and c - s summed as they load. 'default' (ENG_BF16): four
// bf16 tables c, s, c + s, c - s (each sum in float32, then rounded, as
// the plain version's Wc + Ws of either direction), one m16n8k16 product
// each with the bf16 xr, xi and xr + xi of group_dft: 4 bin tiles x 8 k
// steps x 4 = 128 products a task and direction (group_dft's 192), the
// same sums as the twin's at every bin but where the tables' float64
// zeros differ in their last bits (~1e-14). One warp task: the 8 groups
// from `first`, the inverse direction where `inv`, each result to epi (a
// __syncwarp first: an earlier task's results in the groups' slots).
template <int ENG, typename Epi>
__device__ __forceinline__ void group_dft_sym_task(const float* sre, const float* sim, int rs,
                                                   int gpr, int groups, int first, bool inv,
                                                   const void* tab, const Epi& epi) {
  static_assert(ENG == ENG_BF16 || ENG == ENG_TF32X3, "a tensor-core engine");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const DftTask tk(first, groups, gpr, rs, g, t);
  __syncwarp();
  if constexpr (ENG == ENG_BF16) {
    // b0: positions 16 kt + 2t, +1; b1: 16 kt + 2t + 8, +9
    uint32_t br[8][2], bi[8][2], bs[8][2];
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * kt + 2 * t + 8 * h;
        const float r0 = tk.in_ok ? sre[tk.so + pad_idx(p)] : 0.0f;
        const float r1 = tk.in_ok ? sre[tk.so + pad_idx(p + 1)] : 0.0f;
        const float i0 = tk.in_ok ? sim[tk.so + pad_idx(p)] : 0.0f;
        const float i1 = tk.in_ok ? sim[tk.so + pad_idx(p + 1)] : 0.0f;
        br[kt][h] = pack_bf16(r0, r1);
        bi[kt][h] = pack_bf16(i0, i1);
        bs[kt][h] = pack_bf16(r0 + i0, r1 + i1);
      }
    }
    __syncwarp();
    // bin 64 first (the group's values are in registers): a bf16 pair holds
    // positions p (even, +) and p + 1 (odd, -)
    float r1 = 0.0f, r3 = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        r1 += __uint_as_float(br[kt][h] << 16) - __uint_as_float(br[kt][h] & 0xffff0000u);
        r3 += __uint_as_float(bs[kt][h] << 16) - __uint_as_float(bs[kt][h] & 0xffff0000u);
      }
    }
    sym_bin64(r1, r3, t, tk, epi);
    const uint4* A = reinterpret_cast<const uint4*>(tab) + lane;
#pragma unroll 1
    for (int mt = 0; mt < DFT_HALF_TILES; ++mt) {
      float m1[4] = {}, m2[4] = {}, m3[4] = {}, m4[4] = {};
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        const uint4* a = A + (mt * 8 + kt) * 4 * 32;
        mma_bf16(m1, a[0], br[kt][0], br[kt][1]);
        mma_bf16(m2, a[32], bi[kt][0], bi[kt][1]);
        mma_bf16(m3, a[64], bs[kt][0], bs[kt][1]);
        mma_bf16(m4, a[96], bs[kt][0], bs[kt][1]);
      }
      sym_results(m1, m2, m3, m4, mt, g, inv, tk, epi);
    }
  } else {
    // b0: position 8 kt + t; b1: 8 kt + t + 4
    float xr[16][2], xi[16][2];
#pragma unroll
    for (int kt = 0; kt < 16; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 8 * kt + t + 4 * h;
        xr[kt][h] = tk.in_ok ? sre[tk.so + pad_idx(p)] : 0.0f;
        xi[kt][h] = tk.in_ok ? sim[tk.so + pad_idx(p)] : 0.0f;
      }
    }
    __syncwarp();
    // bin 64 first: the lane's positions 8 kt + t + 4 h share the parity of t
    float r1 = 0.0f, r3 = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 16; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        r1 += xr[kt][h];
        r3 += xr[kt][h] + xi[kt][h];
      }
    }
    sym_bin64(t & 1 ? -r1 : r1, t & 1 ? -r3 : r3, t, tk, epi);
    const float4* A = reinterpret_cast<const float4*>(tab) + lane;
#pragma unroll 1
    for (int mt = 0; mt < DFT_HALF_TILES; ++mt) {
      float m1[4] = {}, m2[4] = {}, m3[4] = {}, m4[4] = {};
      sym_products_tf32(xr, xi, A, mt, m1, m2, m3, m4);
      sym_results(m1, m2, m3, m4, mt, g, inv, tk, epi);
    }
  }
}

// B7: the forward group DFT of every group of the block's rows (as
// group_dft_res lays them out), each result to epi
template <int ENG, typename Epi>
__device__ __forceinline__ void group_dft_sym(const float* sre, const float* sim, int rs,
                                              int rows, int gpr, const void* tab,
                                              const Epi& epi) {
  const int groups = rows * gpr;
  for (int first = (threadIdx.x >> 5) * DFT_TASK; first < groups;
       first += (blockDim.x >> 5) * DFT_TASK)
    group_dft_sym_task<ENG>(sre, sim, rs, gpr, groups, first, false, tab, epi);
}

// B2's epilogue of both directions: the forward one's results to fwd (the
// filter and a store into the shared rows), the inverse one's stored
template <typename Epi>
struct PairEpi {
  Epi fwd;
  bool inv;
  __device__ __forceinline__ void operator()(int r, int col, float yr, float yi) const {
    if (inv)
      SmemEpi{fwd.sre, fwd.sim, fwd.rs}(r, col, yr, yi);
    else
      fwd(r, col, yr, yi);
  }
};

// B2: both directions of each warp task in turn, the forward one with epi
// (the filter, its results into the groups' own slots), then the inverse
// one into the same slots: the warp reads only its own groups, so no block
// barrier between the two. 'default' inlines the two directions; 'highest'
// runs one body twice (fewer values live across it: an H100 ran B2 at
// 2 x 2048^2 0.49 ms so against 0.55 ms with two bodies, and the instance
// builds in about half the time)
template <int ENG, typename Epi>
__device__ __forceinline__ void group_dft_sym_pair(const float* sre, const float* sim, int rs,
                                                   int rows, int gpr, const void* tab,
                                                   const Epi& epi) {
  const int groups = rows * gpr;
  for (int first = (threadIdx.x >> 5) * DFT_TASK; first < groups;
       first += (blockDim.x >> 5) * DFT_TASK) {
    if constexpr (ENG == ENG_BF16) {
      group_dft_sym_task<ENG>(sre, sim, rs, gpr, groups, first, false, tab,
                              PairEpi<Epi>{epi, false});
      group_dft_sym_task<ENG>(sre, sim, rs, gpr, groups, first, true, tab,
                              PairEpi<Epi>{epi, true});
    } else {
#pragma unroll 1
      for (int d = 0; d < 2; ++d)
        group_dft_sym_task<ENG>(sre, sim, rs, gpr, groups, first, d == 1, tab,
                                PairEpi<Epi>{epi, d == 1});
    }
  }
}

// The block's rows, from the pair's planes to the padded shared rows: W
// columns a vector (16 bytes where the planes are float32 or bfloat16,
// contiguous and aligned; PairLoad::vec), neighbouring threads on
// neighbouring vectors of a row (conflict-free shared stores: the pad
// word every 32 columns spreads a warp's 4-word strides over all banks),
// V vectors a thread loaded before any is stored, so that each thread
// keeps 32 bytes a plane in flight. N a multiple of 128.
template <typename T, typename O>
__device__ __forceinline__ void rows_to_smem(const TBlockOf<O>& tb, const PairLoad<T>& ld,
                                             int rows, int N) {
  constexpr int W = std::is_same<T, __nv_bfloat16>::value ? 8 : 4;
  constexpr int V = 16 / W;
  const int per_row = N / W, total = rows * per_row;
  for (int v0 = threadIdx.x; v0 < total; v0 += V * blockDim.x) {
    float xr[V][W], xi[V][W];
    int a[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int v = v0 + u * blockDim.x;
      const int r = v / per_row, c = (v - r * per_row) * W;
      a[u] = v < total ? r * tb.rs_smem + pad_idx(c) : -1;  // an item's W columns share a pad block
      if (v < total) ld.template vec<W>(ld.row(r), c, xr[u], xi[u]);
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (a[u] < 0) continue;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        tb.sre[a[u] + e] = xr[u][e];
        tb.sim[a[u] + e] = xi[u][e];
      }
    }
  }
}

// Persistent launch: at most as many blocks as the card holds at once
// (the kernel walks over the `blocks` row blocks itself). The occupancy is
// asked once a kernel, device, thread count and shared memory size, and
// kept for the process (the server launches from its threads).
template <typename... KA, typename... A>
__host__ inline int start_persistent(void (*kernel)(KA...), int blocks, int threads, size_t smem,
                                     cudaStream_t stream, A... args) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, int> grids;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  const auto key = std::make_tuple((const void*)kernel, dev, threads, smem);
  int grid = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = grids.find(key);
    if (it != grids.end()) grid = it->second;
  }
  if (!grid) {
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = per_sm * sms;
    std::lock_guard<std::mutex> lock(mu);
    grids[key] = grid;
  }
  kernel<<<min(blocks, grid), threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}
