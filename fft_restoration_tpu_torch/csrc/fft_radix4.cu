// fft_radix4: forward row FFT with radix-4 DIF stages and a radix-2 tail,
// its stages held in registers.
//
// Replaces fft_restoration_tpu/ops/pallas/fft_radix4.py:fft_rows_radix4_fwd
// (B12, "fftr_radix4_fwd"), the JAX package's experiment on whether
// radix-4 helps (tools/perf_ab.py radix4). Natural input, mixed-radix
// digit-reversed output: the stage lengths run long to short, radix 4
// while L % 4 == 0 (n = 4^a * 2^b), then one radix-2 stage when b = 1
// (at n = 2048 five radix-4 stages and one radix-2), so the output order
// is the JAX kernel's exactly (radix4_output_permutation).
//
// A radix-4 stage of length L, q = L / 4, combines the four elements j,
// j+q, j+2q, j+3q of each L-block: t1 = a+c, t2 = a-c, t3 = b+d,
// t4 = b-d, then
//   y0 = t1 + t3, y1 = t2 - i*t4, y2 = t1 - t3, y3 = t2 + i*t4
// (fft_radix4.py:98-104), and writes y_k * W_L^(j*k) back, W from the
// float32 tables of _r4_tables_np (a lane plane per stage, no sincosf), in
// the JAX operation order (yr*cw - yi*sw, yr*sw + yi*cw). The radix-2
// tail is fft_common.cuh's DIF butterfly on the forward tables. Real
// input (im null) starts from zero imaginary registers and reads nothing.
//
// What bounds it on the H100: it moves what a forward fft_rows pass moves
// (a real (6144, 2048) input: 50 MB in, 101 MB out, 45 us at 3.35 TB/s).
// The design before this one ran each radix-4 stage and the tail as a
// shared-memory pass with a barrier (6 at n = 2048), a thread holding
// four values for one butterfly, and loaded and stored through shared
// memory: 2.4x torch.fft on complex rows.
//
// The design (the wrapper's plan is ops/kernels/fft_radix4.py r4_plan):
// - A thread holds 16 complex values: one item of two radix-4 stages
//   (4^2 = 16), the register footprint of a k = 4 radix-2 group. The
//   stages are cut two a group, long to short; an odd last radix-4 stage
//   takes the radix-2 tail into its group (8-element items, two a
//   thread), or stands alone (4-element items). n = 2048: (2048, 512),
//   (128, 32), (8, 2): 2 shared-memory exchanges, not 6 passes.
// - Item (row, blk, j), j < d = L / E, of a group of E elements holds
//   blk * L + e * d + j, e < E: both of its stages' butterflies stay in
//   the item. The twiddle tables depend on the lane mod L only, so an
//   item reads them at (e << log2 d) | j.
// - The top group loads device memory (the item map: neighbouring
//   threads on neighbouring j, whole 32-byte segments at n >= 128); the
//   bottom group (d = 1: an item is E consecutive elements) stores them
//   as 16-byte vectors (8-byte for the lone radix-2 tail of E = 2).
// - The groups exchange through padded shared rows (one word in 32 left
//   empty, the row stride chosen by the plan); where the plan finds it
//   conflict-free, a middle group rotates its blk field one bit (a
//   warp's blocks two apart: at n = 2048 its items span 8 columns, and
//   blocks 128 words apart would share banks).
// - Geometry as B6's (fft_rows.cu), re-measured by tools/rows_geometry.py:
//   the rows that fit 32 KB (2 at n = 2048), 128 threads looping over the
//   slot sets. A ragged last row block loads zeros and stores nothing
//   past the rows.
#include "fft_common.cuh"

#define R4_SLOTS 16
#define R4_MAX_GROUPS 4
#define R4_THREADS 256
#define R4_MIN_BLOCKS 2

enum { R4_SMEM = 0, R4_DEV = 1 };

// the groups, long to short: group g's items are 2^le[g] elements of a
// block of 2^ll[g], the blk field of the thread map rotated by rot[g]
struct R4Groups {
  int groups;
  int ll[R4_MAX_GROUPS];
  int le[R4_MAX_GROUPS];
  int rot[R4_MAX_GROUPS];
};

// the int32 plan array (fft_radix4.R4Plan.c_plan): groups, then per group
// log2 L, log2 E and rot; false unless the groups cover the log2n stages
// long to short, two radix-4 stages each but the last, the first and the
// last unrotated
__host__ inline bool read_r4_groups(const int* plan, int log2n, R4Groups* gp) {
  if (plan[0] < 1 || plan[0] > R4_MAX_GROUPS) return false;
  *gp = {};
  gp->groups = plan[0];
  int ll = log2n;
  for (int g = 0; g < gp->groups; ++g) {
    gp->ll[g] = plan[1 + 3 * g];
    gp->le[g] = plan[2 + 3 * g];
    gp->rot[g] = plan[3 + 3 * g];
    const bool last = g == gp->groups - 1;
    if (gp->ll[g] != ll || gp->le[g] < 1 || gp->le[g] > 4 || (!last && gp->le[g] != 4) ||
        gp->rot[g] < 0 || gp->rot[g] > 1 || ((g == 0 || last) && gp->rot[g]))
      return false;
    ll -= gp->le[g];
  }
  return ll == 0;
}

// One block's rows: the launch's row m0 in and out, the shared rows
struct R4Block {
  const float* __restrict__ src_re;
  const float* __restrict__ src_im;
  float* __restrict__ out_re;
  float* __restrict__ out_im;
  float* sre;
  float* sim;
  const float* __restrict__ c4;
  const float* __restrict__ s4;
  float c2, s2;  // the radix-2 tail's twiddle (stage 0, lane 0 of the tables)
  int log2n, rs, ns, live_rows;
};

// padded shared-memory column: one word in every 32 left empty
__device__ __forceinline__ int r4_pad(int i) { return i + (i >> 5); }

// One radix-4 DIF butterfly on slots a, a + st, a + 2 st, a + 3 st, the
// output of slot a + k st times the table at lane l0 + k * lst
template <int A, int ST>
__device__ __forceinline__ void radix4(float (&xr)[R4_SLOTS], float (&xi)[R4_SLOTS],
                                       const float* __restrict__ wc,
                                       const float* __restrict__ ws, int l0, int lst) {
  const float ar = xr[A], ai = xi[A], br = xr[A + ST], bi = xi[A + ST];
  const float cr = xr[A + 2 * ST], ci = xi[A + 2 * ST], dr = xr[A + 3 * ST], di = xi[A + 3 * ST];
  const float t1r = ar + cr, t1i = ai + ci;
  const float t2r = ar - cr, t2i = ai - ci;
  const float t3r = br + dr, t3i = bi + di;
  const float t4r = br - dr, t4i = bi - di;
  const float yr[4] = {t1r + t3r, t2r + t4i, t1r - t3r, t2r - t4i};
  const float yi[4] = {t1i + t3i, t2i - t4r, t1i - t3i, t2i + t4r};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cw = __ldg(wc + l0 + k * lst), sw = __ldg(ws + l0 + k * lst);
    xr[A + k * ST] = yr[k] * cw - yi[k] * sw;
    xi[A + k * ST] = yr[k] * sw + yi[k] * cw;
  }
}

// the radix-2 tail's DIF butterfly on slots a, a + 1
template <int A>
__device__ __forceinline__ void radix2(float (&xr)[R4_SLOTS], float (&xi)[R4_SLOTS], float c,
                                       float sn) {
  const float ar = xr[A], ai = xi[A], br = xr[A + 1], bi = xi[A + 1];
  const float dr = ar - br, di = ai - bi;
  xr[A] = ar + br;
  xi[A] = ai + bi;
  xr[A + 1] = c * dr - sn * di;
  xi[A + 1] = c * di + sn * dr;
}

// The stages of item jh (slots jh * E ..) of a group of 2^LE elements,
// its first radix-4 stage s, log2 d = ld, offset j < d
template <int LE, int JH>
__device__ __forceinline__ void r4_item(const R4Block& rb, float (&xr)[R4_SLOTS],
                                        float (&xi)[R4_SLOTS], int s, int ld, int j) {
  constexpr int B = JH << LE;
  const size_t n = (size_t)1 << rb.log2n;
  const float* wc = rb.c4 + s * n;
  const float* ws = rb.s4 + s * n;
  if constexpr (LE == 4) {  // e = k1 * 4 + k2: over k1 (stage s), then over k2 (stage s + 1)
    radix4<B + 0, 4>(xr, xi, wc, ws, j, 4 << ld);
    radix4<B + 1, 4>(xr, xi, wc, ws, (1 << ld) | j, 4 << ld);
    radix4<B + 2, 4>(xr, xi, wc, ws, (2 << ld) | j, 4 << ld);
    radix4<B + 3, 4>(xr, xi, wc, ws, (3 << ld) | j, 4 << ld);
    radix4<B + 0, 1>(xr, xi, wc + n, ws + n, j, 1 << ld);
    radix4<B + 4, 1>(xr, xi, wc + n, ws + n, j, 1 << ld);
    radix4<B + 8, 1>(xr, xi, wc + n, ws + n, j, 1 << ld);
    radix4<B + 12, 1>(xr, xi, wc + n, ws + n, j, 1 << ld);
  } else if constexpr (LE == 3) {  // e = k1 * 2 + m: over k1, then the tail over m
    radix4<B + 0, 2>(xr, xi, wc, ws, j, 2 << ld);
    radix4<B + 1, 2>(xr, xi, wc, ws, (1 << ld) | j, 2 << ld);
    radix2<B + 0>(xr, xi, rb.c2, rb.s2);
    radix2<B + 2>(xr, xi, rb.c2, rb.s2);
    radix2<B + 4>(xr, xi, rb.c2, rb.s2);
    radix2<B + 6>(xr, xi, rb.c2, rb.s2);
  } else if constexpr (LE == 2) {
    radix4<B, 1>(xr, xi, wc, ws, j, 1 << ld);
  } else {
    radix2<B>(xr, xi, rb.c2, rb.s2);
  }
}

template <int LE, int JH = 0>
__device__ __forceinline__ void r4_items(const R4Block& rb, float (&xr)[R4_SLOTS],
                                         float (&xi)[R4_SLOTS], int s, int ld, const int* j) {
  if constexpr (JH < (R4_SLOTS >> LE)) {
    r4_item<LE, JH>(rb, xr, xi, s, ld, j[JH]);
    r4_items<LE, JH + 1>(rb, xr, xi, s, ld, j);
  }
}

// One group of 2^LE-element items of L = 2^ll blocks: slot set g holds
// items g + jh * ns, loaded as LD and stored as ST (R4_DEV: the top
// group's row loads, REAL reading no imaginary part; the bottom group's
// vector stores)
template <int LE, int LD, int ST, bool REAL>
__device__ __forceinline__ void r4_group(const R4Block& rb, int ll, int rot) {
  constexpr int E = 1 << LE, J = R4_SLOTS >> LE;
  const int ld = ll - LE, lb = rb.log2n - ll;
  const int s = lb >> 1;  // the group's first radix-4 stage
  const int n = 1 << rb.log2n;
  const int dmask = (1 << ld) - 1, bmask = (1 << lb) - 1;
  for (int g = threadIdx.x; g < rb.ns; g += blockDim.x) {
    float xr[R4_SLOTS], xi[R4_SLOTS];
    int row[J], off[J], jj[J];
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      const int it = g + jh * rb.ns;
      jj[jh] = it & dmask;
      const int f = (it >> ld) & bmask;
      row[jh] = it >> (ld + lb);
      const int blk = rot && lb > 0 ? ((f << 1) | (f >> (lb - 1))) & bmask : f;
      off[jh] = (blk << ll) | jj[jh];
      const bool live = row[jh] < rb.live_rows;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int col = off[jh] | (e << ld);
        if constexpr (LD == R4_SMEM) {
          const int a = row[jh] * rb.rs + r4_pad(col);
          xr[jh * E + e] = rb.sre[a];
          xi[jh * E + e] = rb.sim[a];
        } else {
          const size_t o = (size_t)row[jh] * n + col;
          xr[jh * E + e] = live ? __ldg(rb.src_re + o) : 0.0f;
          xi[jh * E + e] = (!REAL && live) ? __ldg(rb.src_im + o) : 0.0f;
        }
      }
    }
    r4_items<LE>(rb, xr, xi, s, ld, jj);
#pragma unroll
    for (int jh = 0; jh < J; ++jh) {
      if constexpr (ST == R4_SMEM) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int a = row[jh] * rb.rs + r4_pad(off[jh] | (e << ld));
          rb.sre[a] = xr[jh * E + e];
          rb.sim[a] = xi[jh * E + e];
        }
      } else {  // d = 1: the item's E consecutive elements
        if (row[jh] >= rb.live_rows) continue;
        const size_t o = (size_t)row[jh] * n + off[jh];
        if constexpr (E == 2) {
          *reinterpret_cast<float2*>(rb.out_re + o) = make_float2(xr[2 * jh], xr[2 * jh + 1]);
          *reinterpret_cast<float2*>(rb.out_im + o) = make_float2(xi[2 * jh], xi[2 * jh + 1]);
        } else {
#pragma unroll
          for (int v = 0; v < E; v += 4) {
            const int b = jh * E + v;
            *reinterpret_cast<float4*>(rb.out_re + o + v) =
                make_float4(xr[b], xr[b + 1], xr[b + 2], xr[b + 3]);
            *reinterpret_cast<float4*>(rb.out_im + o + v) =
                make_float4(xi[b], xi[b + 1], xi[b + 2], xi[b + 3]);
          }
        }
      }
    }
  }
}

// B rows of N = 2^log2n points, 2^lr rows a block, padded row stride rs;
// src_im null (REAL) for a real input
template <bool REAL>
__global__ void __launch_bounds__(R4_THREADS, R4_MIN_BLOCKS)
fft_radix4_kernel(const float* __restrict__ src_re, const float* __restrict__ src_im,
                  float* __restrict__ out_re, float* __restrict__ out_im, int B, int log2n,
                  int lr, int rs, const float* __restrict__ c4, const float* __restrict__ s4,
                  const float* __restrict__ c2, const float* __restrict__ s2,
                  const __grid_constant__ R4Groups gp) {
  extern __shared__ float smem[];
  const int rows = 1 << lr;
  const int m0 = blockIdx.x * rows;
  const size_t base = (size_t)m0 << log2n;
  const R4Block rb = {src_re + base, REAL ? nullptr : src_im + base, out_re + base,
                      out_im + base, smem, smem + rows * rs, c4, s4, __ldg(c2), __ldg(s2),
                      log2n, rs, (rows << log2n) / R4_SLOTS, min(rows, B - m0)};
  const int G = gp.groups;
  if (G == 1) {  // n <= 16: one group, device to device
    switch (gp.le[0]) {
      case 2: r4_group<2, R4_DEV, R4_DEV, REAL>(rb, gp.ll[0], gp.rot[0]); break;
      case 3: r4_group<3, R4_DEV, R4_DEV, REAL>(rb, gp.ll[0], gp.rot[0]); break;
      default: r4_group<4, R4_DEV, R4_DEV, REAL>(rb, gp.ll[0], gp.rot[0]); break;
    }
    return;
  }
  r4_group<4, R4_DEV, R4_SMEM, REAL>(rb, gp.ll[0], gp.rot[0]);
  for (int g = 1; g < G - 1; ++g) {
    __syncthreads();
    r4_group<4, R4_SMEM, R4_SMEM, false>(rb, gp.ll[g], gp.rot[g]);
  }
  __syncthreads();
  switch (gp.le[G - 1]) {
    case 1: r4_group<1, R4_SMEM, R4_DEV, false>(rb, gp.ll[G - 1], gp.rot[G - 1]); break;
    case 2: r4_group<2, R4_SMEM, R4_DEV, false>(rb, gp.ll[G - 1], gp.rot[G - 1]); break;
    case 3: r4_group<3, R4_SMEM, R4_DEV, false>(rb, gp.ll[G - 1], gp.rot[G - 1]); break;
    default: r4_group<4, R4_SMEM, R4_DEV, false>(rb, gp.ll[G - 1], gp.rot[G - 1]); break;
  }
}

template <bool REAL>
static int launch_r4(const void* re, const void* im, void* out_re, void* out_im, int B,
                     int log2n, int lr, int rs, int threads, const void* c4, const void* s4,
                     const void* c2, const void* s2, const R4Groups& gp, cudaStream_t stream) {
  const size_t smem = gp.groups > 1 ? 2 * sizeof(float) * ((size_t)rs << lr) : 0;
  cudaError_t err = allow_smem(fft_radix4_kernel<REAL>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)B + (1 << lr) - 1) >> lr;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fft_radix4_kernel<REAL><<<(int)blocks, threads, smem, stream>>>(
      (const float*)re, (const float*)im, (float*)out_re, (float*)out_im, B, log2n, lr, rs,
      (const float*)c4, (const float*)s4, (const float*)c2, (const float*)s2, gp);
  return (int)cudaGetLastError();
}

// B rows of 2^log2n points (log2n >= 2), 2^lr rows a block (2^(lr +
// log2n) >= 16), padded row stride rs >= n + n / 32, `threads` a multiple
// of 32 up to 256; c4/s4 the (radix-4 stages, N) tables, c2/s2 the (log2n,
// N) radix-2 forward tables (the tail reads their stage 0, lane 0); plan:
// the wrapper's r4_plan (read_r4_groups); im null for a real input
extern "C" int fft_radix4_launch(const void* re, const void* im, void* out_re, void* out_im,
                                 int B, int log2n, int lr, int rs, int threads, const void* c4,
                                 const void* s4, const void* c2, const void* s2,
                                 const int* plan, void* stream) {
  R4Groups gp;
  const int n = 1 << log2n;
  if (log2n < 2 || log2n > 14 || lr < 0 || log2n + lr < 4 || B < 1 || rs < n + (n >> 5) ||
      threads < 32 || threads > R4_THREADS || threads % 32 || !read_r4_groups(plan, log2n, &gp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FFT_R4_ARGS re, im, out_re, out_im, B, log2n, lr, rs, threads, c4, s4, c2, s2, gp, s
  if (im == nullptr) return launch_r4<true>(FFT_R4_ARGS);
  return launch_r4<false>(FFT_R4_ARGS);
#undef FFT_R4_ARGS
}
