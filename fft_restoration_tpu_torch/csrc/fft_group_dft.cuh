// The group DFT of the MXU engine on the tensor cores: every contiguous
// 128-point group of a block's shared rows times the 128 x 128 DFT matrix.
//
// Counterpart of fft_restoration_tpu/ops/pallas/fft_kernel.py
// _group_dft_matmul (engine="mxu"): the JAX hybrid engine runs the outer
// radix-2 stages (butterfly distance >= 128) and replaces the inner
// log2(128) = 7 with one natural-order DFT-128 of each contiguous group,
// a matrix product on the TPU's MXU. Forward (DIF): the outer stages, then
// the group DFT, so the spectrum lands in the "hybrid order" (bin k at
// rev_b(k mod G) * 128 + k div G, G = q / 128); inverse (DIT): the
// inverse group DFT first, then the outer stages. The forward B1 and B6
// passes and B7 at 'default' (fft_rows_t.cu fft_rows_t_l2_kernel, fft_rows.cu
// fft_rows_l2_kernel, wiener_spectral.cu spectral_s_l2_kernel) call it
// between their stage groups (fft_groups.cuh) and their stores, reading
// the tables through L1 and L2 for every task; every other tensor-core
// instance (B1, B3/B6, B2, B7 at 'highest') runs fft_group_dft_smem.cuh's,
// whose tables stay in shared memory.
//
// The product is the JAX package's three real products (Karatsuba):
//   m1 = xr Wc, m2 = xi Ws, m3 = (xr + xi)(Wc + Ws),
//   yr = m1 - m2, yi = (m3 - m1) - m2,
// with Wc, Ws of the float64-built _dft_planes_np(128, inverse) and
// Wc + Ws summed in float32 on the host.
//   ENG_BF16   ('default', the JAX flagship): one bf16 pass,
//              mma.sync m16n8k16 bf16 x bf16 -> f32; xr, xi and xr + xi
//              (summed in f32) rounded to bf16 as they are packed, the
//              three tables rounded to bf16 on the host.
//   ENG_TF32X3 ('highest'): 3xTF32 on mma.sync m16n8k8 tf32: each operand
//              split into a tf32 hi part and the tf32 of its remainder,
//              a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32, about
//              float32's accuracy.
// The plain version (ops/kernels/fft_kernel.group_dft_plain) rounds the
// same operands and takes the f32 products.
//
// The mapping: the matrix product runs transposed, Y^T = W^T X^T, so the
// DFT matrix is the A operand (16 bins x the K positions of an mma) and a
// warp's task of 8 groups is the B operand's 8 columns. A lane holds, for
// group g = lane / 4, the quarter of its 128 positions the B fragments
// take (t = lane % 4), in registers for the whole task: the result then
// overwrites the group's own shared slots with no block barrier (no other
// warp reads them), bin tile by bin tile. The A fragments are constants,
// laid out on the host in fragment order ([bin tile][k step][table][lane],
// fft_kernel.dft_fragments), one 16-byte read-only load a lane a table
// and k step. An epilogue functor takes each result (row, column, yr, yi):
// a shared store, or B7's filter and store.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "fft_groups.cuh"

#define DFT_N 128
#define DFT_LOG 7
#define DFT_TASK 8  // groups a warp task (the mma's N)

// the butterfly engine of an instance: the radix-2 stages only, or the
// outer stages and the group DFT at one of the two precisions
enum { ENG_ROLL = 0, ENG_BF16 = 1, ENG_TF32X3 = 2 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the lower column, in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float4& w, float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
  split_tf32(w.x, ah[0], al[0]);
  split_tf32(w.y, ah[1], al[1]);
  split_tf32(w.z, ah[2], al[2]);
  split_tf32(w.w, ah[3], al[3]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// the result of a group DFT into the block's shared rows (in place)
struct SmemEpi {
  float* sre;
  float* sim;
  int rs;
  __device__ __forceinline__ void operator()(int r, int col, float yr, float yi) const {
    const int a = r * rs + pad_idx(col);
    sre[a] = yr;
    sim[a] = yi;
  }
};

// The group DFT of every 128-point group of the block's rows (rows x gpr
// groups, gpr = N / 128; group gi = r * gpr + c holds columns c * 128 ..
// c * 128 + 127 of row r, padded as the stage groups pad them), each
// result handed to epi(r, column, yr, yi). tab: the fragment tables of
// one direction (fft_kernel.dft_fragments). The caller puts a block
// barrier before (the groups' values in shared memory) and after.
template <int ENG, typename Epi>
__device__ __forceinline__ void group_dft(const float* sre, const float* sim, int rs, int rows,
                                          int gpr, const void* __restrict__ tab, const Epi& epi) {
  static_assert(ENG == ENG_BF16 || ENG == ENG_TF32X3, "a tensor-core engine");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = rows * gpr;
  for (int task = threadIdx.x >> 5; task * DFT_TASK < groups; task += blockDim.x >> 5) {
    // the lane's B column: group task * 8 + g, at shared offset so + pad_idx(pos)
    const int gin = task * DFT_TASK + g;
    const bool in_ok = gin < groups;
    const int rin = in_ok ? gin / gpr : 0;
    const int so = rin * rs + (in_ok ? gin - rin * gpr : 0) * (DFT_N + DFT_N / 32);
    // the lane's D columns: groups task * 8 + 2t + e, e < 2 (row, first column)
    int orow[2], ocol[2];
    bool out_ok[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int go = task * DFT_TASK + 2 * t + e;
      out_ok[e] = go < groups;
      orow[e] = out_ok[e] ? go / gpr : 0;
      ocol[e] = (go - orow[e] * gpr) * DFT_N;
    }
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
      const uint4* A = reinterpret_cast<const uint4*>(tab) + lane;
#pragma unroll 1
      for (int mt = 0; mt < 8; ++mt) {
        float m1[4] = {}, m2[4] = {}, m3[4] = {};
#pragma unroll
        for (int kt = 0; kt < 8; ++kt) {
          const uint4* a = A + (mt * 8 + kt) * 3 * 32;
          mma_bf16(m1, __ldg(a), br[kt][0], br[kt][1]);
          mma_bf16(m2, __ldg(a + 32), bi[kt][0], bi[kt][1]);
          mma_bf16(m3, __ldg(a + 64), bs[kt][0], bs[kt][1]);
        }
        // d[e]: bin 16 mt + g + 8 (e >> 1) of group 2t + (e & 1)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (out_ok[e & 1])
            epi(orow[e & 1], ocol[e & 1] + 16 * mt + g + 8 * (e >> 1), m1[e] - m2[e],
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
      for (int mt = 0; mt < 8; ++mt) {
        float m1[4] = {}, m2[4] = {}, m3[4] = {};
#pragma unroll 2
        for (int kt = 0; kt < 16; ++kt) {
          const float4* a = A + (mt * 16 + kt) * 3 * 32;
          mma_3xtf32(m1, __ldg(a), xr[kt][0], xr[kt][1]);
          mma_3xtf32(m2, __ldg(a + 32), xi[kt][0], xi[kt][1]);
          mma_3xtf32(m3, __ldg(a + 64), xr[kt][0] + xi[kt][0], xr[kt][1] + xi[kt][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (out_ok[e & 1])
            epi(orow[e & 1], ocol[e & 1] + 16 * mt + g + 8 * (e >> 1), m1[e] - m2[e],
                m3[e] - m1[e] - m2[e]);
      }
    }
  }
}

// The outer-stage plan of an mxu instance (fft_kernel's plans with
// engine "mxu"): 0 to T_MAX_GROUPS groups over the stages 7 .. logq - 1;
// false when a group is out of range or they do not add up
__host__ inline bool read_mxu_plan(const int* plan, int logq, GroupPlan* gp) {
  if (plan[0] < 0 || plan[0] > T_MAX_GROUPS || logq < DFT_LOG) return false;
  *gp = {};
  gp->groups = plan[0];
  gp->direct_store = plan[1];
  int stages = 0;
  for (int g = 0; g < gp->groups; ++g) {
    gp->s_lo[g] = plan[2 + 4 * g];
    gp->k[g] = plan[3 + 4 * g];
    gp->ub_shift[g] = plan[4 + 4 * g];
    gp->row_shift[g] = plan[5 + 4 * g];
    if (gp->k[g] < 1 || gp->k[g] > 4 || gp->s_lo[g] < DFT_LOG) return false;
    stages += gp->k[g];
  }
  return stages == logq - DFT_LOG;
}

// Launch `kernel` with its dynamic shared memory limit raised to smem
template <typename... KA, typename... A>
__host__ inline int start_kernel(void (*kernel)(KA...), int blocks, int threads, size_t smem,
                                 cudaStream_t stream, A... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}
