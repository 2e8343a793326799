// postprocess: the white-balance passes, Lab-L partial sums (B4/B8a) and
// the white-balanced uint8 encode (B5/B8b).
//
// Replaces fft_restoration_tpu/ops/pallas/postprocess.py:
//   B8a lab_l_sum_partials_batched ("ppk_lab_l_partials_b"; B4
//       lab_l_sum_partials, "ppk_lab_l_partials", is its B = 1 case): in
//       one pass over the raw inverse-FFT planes and the original frames,
//       the per-plane min-max normalize and the Lab-L sums of both, per
//       image and sampled row block (the two means of each image's gain);
//   B8b wb_encode_u8_batched ("ppk_wb_encode_b"; B5 wb_encode_u8,
//       "ppk_wb_encode"): normalize -> BGR->Lab -> clip(L * gain_i, 0,
//       100) -> Lab->BGR -> clip(* 255) -> uint8 through int32, written
//       straight into the interleaved (B, h, w, 3) stack.
// Every expression follows ops/color.py (the plain versions): powers as
// exp2(log2(max(x, 1e-30)) * p), the same float32 constants (the color
// matrices come from the wrapper), divisions by constants as products
// with their float32 reciprocals, as PyTorch computes `tensor / scalar` on
// the card.
//
// What bounds them on the H100: bytes and the special-function unit
// (SFU: 16 operations a clock an SM; a power is one lg2 and one ex2).
// At 2048^2 each pass moves 62.9 MB (three float32 planes and three
// uint8 channels of the live frame), 18.8 us at 3.35 TB/s. B5 takes 9
// powers a pixel (18 SFU operations: 4.9 us per megapixel at 132 SMs and
// 1.755 GHz, 20 us at 2048^2), B4 8 (16), of which the original frame's
// three sRGB -> linear powers read a 256-entry table here instead: 10,
// 2.7 us per megapixel (11 us). The Triton kernels before these read 6x
// their bytes bound:
// 256 programs of 4 warps at 2048^2 looping over their rows, every power
// on both branches of a select, byte-wise interleaved loads and stores.
//
// The design:
// - A block is 256 threads, TX columns of 4-pixel groups by TY rows (TX a
//   power of two from 32 to 256, the fewest idle threads on a live row:
//   postprocess.columns_log2). A thread takes 4 consecutive
//   pixels of a row: one float4 from each raw plane (the plane width a
//   multiple of 4; a narrower one loads scalars), the pixels past the live
//   width masked.
// - 1D grid with 64-bit offsets. The wrapper's plan
//   (ops/kernels/postprocess.py lab_l_plan, wb_encode_plan) cuts each
//   image into CUDA blocks of `slab` rows (4 rows a thread) by 4 * TX
//   columns: B4's sampled row blocks of `_block_geometry` rows (every
//   stride-th) are split into slabs, and only the sampled ones are
//   launched.
// - B4: one partial pair a CUDA block (per-thread float32 sums, warp
//   shuffles, one shared-memory step), in block order; the wrapper sums
//   a row block's slabs and chunks in a fixed order. No atomics: two
//   launches on one input give the same bits.
// - B4's original frame: the interleaved (B, h, w, 3) uint8 stack (its
//   permuted view, as the pipelines pass it) loads a group's 12 bytes as
//   three 32-bit words where they are aligned; any other strides, and
//   float32 frames, load element by element. Its sRGB -> linear comes from
//   a 256-entry shared-memory table each block builds in its prologue
//   with true divisions (the uint8 -> unit step and the two of the
//   formula, as ops.kernels.u8_to_unit divides; with reciprocal products,
//   40 of the 256 powers' bases would differ in the last place) and
//   exp2f / log2f. The same formula in plain torch on the CPU gives the
//   plain conversion bit for bit (tests/test_torch_postprocess_plan.py);
//   the card's table is held to the plain version through the partials.
// - B5: the gain, lo and scale are read once a block (a block lies in one
//   image); a group's 12 output bytes are packed into three 32-bit words
//   and stored where aligned (always when w % 4 == 0), byte by byte
//   elsewhere.
// - The powers take lg2.approx.ftz / ex2.approx.ftz, within the plain
//   version's tolerances. exp2f / log2f (log2f is a libdevice routine of
//   some 40 instructions with no MUFU.LG2) took 1.7-2.4x the time on an
//   H100 (PERF.md). No -use_fast_math: the flags of the other sources
//   are unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

#define PP_THREADS 256

// the float32 color matrices of ops/color.py: M_SRGB2XYZ (rows over
// (r, g, b) inputs, scaled by the white point), M_XYZ2SRGB, D65
struct Color {
  float xyz[9];
  float rgb[9];
  float white[3];
};

// the plain version's Python constants, rounded to float32 as PyTorch
// rounds a scalar operand of a float32 tensor
#define PP_T0 0.008856f
#define PP_CBRT_A 7.787f
#define PP_CBRT_B ((float)(16.0 / 116.0))

// x^p as exp2(log2(max(x, 1e-30)) * p), both on the SFU
__device__ __forceinline__ float pow_pos(float x, float p) {
  float l, r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(fmaxf(x, 1e-30f)));
  l *= p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(l));
  return r;
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ float srgb_to_linear(float x) {
  x = clamp01(x);
  return x <= 0.04045f ? x * (1.0f / 12.92f)
                       : pow_pos((x + 0.055f) * (1.0f / 1.055f), 2.4f);
}

// one entry of the uint8 table: true divisions, precise powers
__device__ float srgb_to_linear_u8(int v) {
  const float x = (float)v / 255.0f;
  return x <= 0.04045f ? x / 12.92f : exp2f(log2f(fmaxf((x + 0.055f) / 1.055f, 1e-30f)) * 2.4f);
}

__device__ __forceinline__ float f_cbrt(float t) {
  return t > PP_T0 ? pow_pos(t, (float)(1.0 / 3.0)) : PP_CBRT_A * t + PP_CBRT_B;
}

__device__ __forceinline__ float l_of_y(float y) {
  return y > PP_T0 ? 116.0f * pow_pos(y, (float)(1.0 / 3.0)) - 16.0f : 903.3f * y;
}

// Lab L of linear (b, g, r): the Y row of M_SRGB2XYZ applied to bgr planes
__device__ __forceinline__ float y_of(const Color& c, float lb, float lg, float lr) {
  return c.xyz[5] * lb + c.xyz[4] * lg + c.xyz[3] * lr;
}

__device__ __forceinline__ float inv_f(float f) {
  const float f3 = f * f * f;
  return f3 > PP_T0 ? f3 : (f - PP_CBRT_B) * (1.0f / PP_CBRT_A);
}

__device__ __forceinline__ uint32_t to_u8(float x) {
  x = fmaxf(x, 0.0f);
  const float v = x <= 0.0031308f ? 12.92f * x
                                  : 1.055f * pow_pos(x, (float)(1.0 / 2.4)) - 0.055f;
  // clip to [0, 1], then * 255 clipped and truncated through int32
  return (uint32_t)(int)fminf(fmaxf(clamp01(v) * 255.0f, 0.0f), 255.0f);
}

// the white-balanced encode of one normalized BGR pixel: b | g << 8 | r << 16
__device__ __forceinline__ uint32_t encode_px(const Color& c, float nb, float ng, float nr,
                                              float gain) {
  const float lb = srgb_to_linear(nb), lg = srgb_to_linear(ng), lr = srgb_to_linear(nr);
  const float tx = c.xyz[2] * lb + c.xyz[1] * lg + c.xyz[0] * lr;
  const float ty = c.xyz[5] * lb + c.xyz[4] * lg + c.xyz[3] * lr;
  const float tz = c.xyz[8] * lb + c.xyz[7] * lg + c.xyz[6] * lr;
  const float fx = f_cbrt(tx), fy = f_cbrt(ty), fz = f_cbrt(tz);
  float L = ty > PP_T0 ? 116.0f * fy - 16.0f : 903.3f * ty;
  const float a = 500.0f * (fx - fy), bb = 200.0f * (fy - fz);
  L = fminf(fmaxf(L * gain, 0.0f), 100.0f);
  const float gy = (L + 16.0f) * (1.0f / 116.0f);
  const float gx = gy + a * (1.0f / 500.0f);
  const float gz = gy - bb * (1.0f / 200.0f);
  const float x = inv_f(gx) * c.white[0], y = inv_f(gy) * c.white[1], z = inv_f(gz) * c.white[2];
  const float r = c.rgb[0] * x + c.rgb[1] * y + c.rgb[2] * z;
  const float g = c.rgb[3] * x + c.rgb[4] * y + c.rgb[5] * z;
  const float b = c.rgb[6] * x + c.rgb[7] * y + c.rgb[8] * z;
  return to_u8(b) | to_u8(g) << 8 | to_u8(r) << 16;
}

// one row's 4-pixel group of the three raw planes at `off`, normalized;
// `live` pixels (1..4) of it lie inside the frame
template <bool VEC>
__device__ __forceinline__ void load_group(const float* __restrict__ p, long long plane,
                                           long long off, int live, const float* lo,
                                           const float* sc, float (&v)[3][4]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* q = p + ch * plane + off;
    float4 x;
    if (VEC) {
      x = __ldg(reinterpret_cast<const float4*>(q));
    } else {
      x.x = __ldg(q);
      x.y = live > 1 ? __ldg(q + 1) : 0.0f;
      x.z = live > 2 ? __ldg(q + 2) : 0.0f;
      x.w = live > 3 ? __ldg(q + 3) : 0.0f;
    }
    v[ch][0] = (x.x - lo[ch]) * sc[ch];
    v[ch][1] = (x.y - lo[ch]) * sc[ch];
    v[ch][2] = (x.z - lo[ch]) * sc[ch];
    v[ch][3] = (x.w - lo[ch]) * sc[ch];
  }
}

// B4 / B8a: the launch's geometry (ops/kernels/postprocess.py LabPlan)
struct LabArgs {
  long long plane;        // h0 * w0, elements of one raw plane
  long long o_bs, o_cs, o_rs, o_ws;  // orig strides (elements)
  int w0;                 // raw row stride
  int h, w;               // live extent
  int rows, stride;       // sampled row blocks: rows [i * stride * rows, + rows)
  int n_blocks, slab, n_slabs, n_chunks;
  int tx_log2;            // TX = 1 << tx_log2 groups a row, TY = 256 / TX rows
  int o_words;            // orig is the interleaved uint8 stack, 4-byte aligned
};

// CUDA block k = ((image * n_blocks + block) * n_slabs + slab) * n_chunks
// + chunk; its partial pair goes to parts[2k], parts[2k + 1]
template <bool VEC, bool ORIG_U8>
__global__ void __launch_bounds__(PP_THREADS) lab_l_partials_kernel(
    const float* __restrict__ raw, const void* __restrict__ orig,
    const float* __restrict__ lo_all, const float* __restrict__ sc_all,
    float* __restrict__ parts, LabArgs a, Color c) {
  __shared__ float lut[256];
  __shared__ float red[2][PP_THREADS / 32];
  const int tid = threadIdx.x;
  if (ORIG_U8) {
    lut[tid] = srgb_to_linear_u8(tid);
    __syncthreads();
  }
  unsigned k = blockIdx.x;
  const int chunk = k % a.n_chunks;
  k /= a.n_chunks;
  const int slab = k % a.n_slabs;
  k /= a.n_slabs;
  const int blk = k % a.n_blocks;
  const long long img = k / a.n_blocks;

  const int tx = tid & ((1 << a.tx_log2) - 1), ty = tid >> a.tx_log2;
  const int TY = PP_THREADS >> a.tx_log2;
  const int row0 = blk * a.stride * a.rows + slab * a.slab;
  const int row1 = min(min(row0 + a.slab, blk * a.stride * a.rows + a.rows), a.h);
  const int col = (chunk << (a.tx_log2 + 2)) + 4 * tx;
  const int live = min(4, a.w - col);

  float lo[3], sc[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    lo[ch] = __ldg(lo_all + 3 * img + ch);
    sc[ch] = __ldg(sc_all + 3 * img + ch);
  }
  const float* p = raw + 3 * img * a.plane;
  float acc_d = 0.0f, acc_o = 0.0f;
  if (live > 0) {
    for (int r = row0 + ty; r < row1; r += TY) {
      float v[3][4];
      load_group<VEC>(p, a.plane, (long long)r * a.w0 + col, live, lo, sc, v);
      float ob[4], og[4], orr[4];
      const long long ob0 = img * a.o_bs + r * a.o_rs + col * a.o_ws;
      if (ORIG_U8) {
        const uint8_t* o = static_cast<const uint8_t*>(orig) + ob0;
        if (a.o_words && live == 4 && (ob0 & 3) == 0) {
          const uint32_t* q = reinterpret_cast<const uint32_t*>(o);
          const uint32_t w0 = __ldg(q), w1 = __ldg(q + 1), w2 = __ldg(q + 2);
          ob[0] = lut[w0 & 255];         og[0] = lut[(w0 >> 8) & 255];
          orr[0] = lut[(w0 >> 16) & 255]; ob[1] = lut[w0 >> 24];
          og[1] = lut[w1 & 255];         orr[1] = lut[(w1 >> 8) & 255];
          ob[2] = lut[(w1 >> 16) & 255];  og[2] = lut[w1 >> 24];
          orr[2] = lut[w2 & 255];        ob[3] = lut[(w2 >> 8) & 255];
          og[3] = lut[(w2 >> 16) & 255];  orr[3] = lut[w2 >> 24];
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint8_t* e = o + j * a.o_ws;
            const bool in = j < live;
            ob[j] = in ? lut[__ldg(e)] : 0.0f;
            og[j] = in ? lut[__ldg(e + a.o_cs)] : 0.0f;
            orr[j] = in ? lut[__ldg(e + 2 * a.o_cs)] : 0.0f;
          }
        }
      } else {
        const float* o = static_cast<const float*>(orig) + ob0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* e = o + j * a.o_ws;
          const bool in = j < live;
          ob[j] = in ? srgb_to_linear(__ldg(e)) : 0.0f;
          og[j] = in ? srgb_to_linear(__ldg(e + a.o_cs)) : 0.0f;
          orr[j] = in ? srgb_to_linear(__ldg(e + 2 * a.o_cs)) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < live) {
          acc_d += l_of_y(y_of(c, srgb_to_linear(v[0][j]), srgb_to_linear(v[1][j]),
                               srgb_to_linear(v[2][j])));
          acc_o += l_of_y(y_of(c, ob[j], og[j], orr[j]));
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc_d += __shfl_xor_sync(0xffffffffu, acc_d, o);
    acc_o += __shfl_xor_sync(0xffffffffu, acc_o, o);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = acc_d;
    red[1][tid >> 5] = acc_o;
  }
  __syncthreads();
  if (tid == 0) {
    float d = 0.0f, o = 0.0f;
#pragma unroll
    for (int i = 0; i < PP_THREADS / 32; ++i) {
      d += red[0][i];
      o += red[1][i];
    }
    parts[2 * (long long)blockIdx.x] = d;
    parts[2 * (long long)blockIdx.x + 1] = o;
  }
}

// B5 / B8b: the launch's geometry (ops/kernels/postprocess.py EncPlan)
struct EncArgs {
  long long plane;  // h0 * w0
  int w0, h, w;
  int slab, n_slabs, n_chunks;  // an image's CUDA blocks: slab rows by 4 * TX columns
  int tx_log2;
};

// CUDA block k = (image * n_slabs + slab) * n_chunks + chunk
template <bool VEC>
__global__ void __launch_bounds__(PP_THREADS) wb_encode_kernel(
    const float* __restrict__ raw, const float* __restrict__ gains,
    const float* __restrict__ lo_all, const float* __restrict__ sc_all,
    uint8_t* __restrict__ out, EncArgs a, Color c) {
  const int tid = threadIdx.x;
  unsigned k = blockIdx.x;
  const int chunk = k % a.n_chunks;
  k /= a.n_chunks;
  const int slab = k % a.n_slabs;
  const long long img = k / a.n_slabs;
  const int tx = tid & ((1 << a.tx_log2) - 1), ty = tid >> a.tx_log2;
  const int TY = PP_THREADS >> a.tx_log2;
  const int col = (chunk << (a.tx_log2 + 2)) + 4 * tx;
  const int live = min(4, a.w - col);
  if (live <= 0) return;
  const int row1 = min(slab * a.slab + a.slab, a.h);

  float lo[3], sc[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    lo[ch] = __ldg(lo_all + 3 * img + ch);
    sc[ch] = __ldg(sc_all + 3 * img + ch);
  }
  const float gain = __ldg(gains + img);
  const float* p = raw + 3 * img * a.plane;
  for (int r = slab * a.slab + ty; r < row1; r += TY) {
    float v[3][4];
    load_group<VEC>(p, a.plane, (long long)r * a.w0 + col, live, lo, sc, v);
    uint32_t px[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) px[j] = encode_px(c, v[0][j], v[1][j], v[2][j], gain);
    const long long e = ((img * a.h + r) * a.w + col) * 3;
    uint8_t* o = out + e;
    if (live == 4 && (e & 3) == 0) {
      uint32_t* q = reinterpret_cast<uint32_t*>(o);
      q[0] = px[0] | px[1] << 24;
      q[1] = px[1] >> 8 | px[2] << 16;
      q[2] = px[2] >> 16 | px[3] << 8;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < live) {
          o[3 * j] = (uint8_t)px[j];
          o[3 * j + 1] = (uint8_t)(px[j] >> 8);
          o[3 * j + 2] = (uint8_t)(px[j] >> 16);
        }
      }
    }
  }
}

static Color color_from(const float* host) {
  Color c;
  for (int i = 0; i < 9; ++i) c.xyz[i] = host[i];
  for (int i = 0; i < 9; ++i) c.rgb[i] = host[9 + i];
  for (int i = 0; i < 3; ++i) c.white[i] = host[18 + i];
  return c;
}

// raw, orig (uint8 when orig_u8, else float32), lo, scale, parts (n_ctas
// pairs); the LabArgs fields; vec: float4 raw loads (w0 % 4 == 0, 16-byte
// aligned planes); color: 21 host float32 values
extern "C" int lab_l_partials_launch(
    const void* raw, const void* orig, int orig_u8, const void* lo, const void* scale,
    void* parts, long long plane, int w0, long long o_bs, long long o_cs, long long o_rs,
    long long o_ws, int o_words, int h, int w, int rows, int stride, int n_blocks, int slab,
    int n_slabs, int n_chunks, int tx_log2, long long n_ctas, int vec,
    const float* color, void* stream) {
  if (n_ctas < 1 || n_ctas > 0x7fffffffLL || tx_log2 < 5 || tx_log2 > 8 || slab < 1)
    return (int)cudaErrorInvalidValue;
  const LabArgs a{plane, o_bs, o_cs, o_rs, o_ws, w0, h, w, rows, stride,
                  n_blocks, slab, n_slabs, n_chunks, tx_log2, o_words};
  const Color c = color_from(color);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)n_ctas;
  const float *r = (const float*)raw, *l = (const float*)lo, *sc = (const float*)scale;
  float* out = (float*)parts;
#define PP_LAB(V, U) lab_l_partials_kernel<V, U><<<g, PP_THREADS, 0, s>>>(r, orig, l, sc, out, a, c)
  if (vec) { if (orig_u8) PP_LAB(true, true); else PP_LAB(true, false); }
  else { if (orig_u8) PP_LAB(false, true); else PP_LAB(false, false); }
#undef PP_LAB
  return (int)cudaGetLastError();
}

// raw, gains, lo, scale, out (B, h, w, 3) uint8; the EncArgs fields; vec,
// color as above
extern "C" int wb_encode_launch(const void* raw, const void* gains, const void* lo,
                                const void* scale, void* out, long long plane, int w0, int h,
                                int w, int slab, int n_slabs, int n_chunks, int tx_log2,
                                long long n_ctas, int vec, const float* color,
                                void* stream) {
  if (n_ctas < 1 || n_ctas > 0x7fffffffLL || tx_log2 < 5 || tx_log2 > 8 || slab < 1)
    return (int)cudaErrorInvalidValue;
  const EncArgs a{plane, w0, h, w, slab, n_slabs, n_chunks, tx_log2};
  const Color c = color_from(color);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)n_ctas;
  const float *r = (const float*)raw, *gn = (const float*)gains, *l = (const float*)lo,
              *sc = (const float*)scale;
  uint8_t* o = (uint8_t*)out;
  if (vec) wb_encode_kernel<true><<<g, PP_THREADS, 0, s>>>(r, gn, l, sc, o, a, c);
  else wb_encode_kernel<false><<<g, PP_THREADS, 0, s>>>(r, gn, l, sc, o, a, c);
  return (int)cudaGetLastError();
}
