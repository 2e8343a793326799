// The row kernels' strided loader (fft_rows.cu, fft_rows_t.cu): pair p of
// a launch reads logical plane q = p*qstep as re and q + qim as im, each
// from its own base pointer, element (q, m, c) at
//   (q / channels) * is + (q % channels) * chs + m * rs + c * cs
// when the pair is live (p < re_live, p < im_live), m < live_rows and
// c < live_cols, else 0. The (image, channel) map makes one loader serve
// contiguous (P, M, N) planes (channels = 1, qstep = 1), the even/odd
// channel planes of one (H, W, 3) frame, and a (B, H, W, 3) image stack
// whose channel pairs straddle images (channels = 3, qstep = 2, qim = 1:
// plane q is image q / 3, channel q % 3), all with their zero pad and no
// copy. uint8 converts as x / 255.0f correctly rounded, the true division
// of the TPU kernel's _load_f32, computed as a product and one FMA
// correction step (the same float for each of the 256 values:
// tests/test_torch_fft_passes.py), not the division's slow path.
// bfloat16 planes (bf16 staging: the image's spectral planes between
// kernels) widen exactly to float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) {
  const float a = (float)v, r = 1.0f / 255.0f;
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-255.0f, q, a), r, q);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct PairLoad {
  const T* __restrict__ re;
  const T* __restrict__ im;
  long long base_re, base_im, rs, cs;
  bool re_ok, im_ok;
  int live_rows, live_cols, m0;

  __device__ __forceinline__ PairLoad(const T* src_re, const T* src_im, long long is,
                                      long long chs, int channels, int qstep,
                                      int qim, long long rs_, long long cs_,
                                      int re_live, int im_live, int live_rows_,
                                      int live_cols_, int p, int m0_)
      : re(src_re), im(src_im), rs(rs_), cs(cs_), live_rows(live_rows_),
        live_cols(live_cols_), m0(m0_) {
    re_ok = p < re_live;
    im_ok = src_im != nullptr && p < im_live;
    const int q_re = p * qstep, q_im = p * qstep + qim;
    base_re = (long long)(q_re / channels) * is + (long long)(q_re % channels) * chs;
    base_im = (long long)(q_im / channels) * is + (long long)(q_im % channels) * chs;
  }

  // row r of the block: its two row pointers and whether each is live
  struct Row {
    const T* re;
    const T* im;
    bool re_ok, im_ok;
  };
  __device__ __forceinline__ Row row(int r) const {
    const int m = m0 + r;
    const bool live = m < live_rows;
    return {re + base_re + m * rs, im_ok ? im + base_im + m * rs : nullptr, live && re_ok,
            live && im_ok};
  }

  // element c of a row, zero outside
  __device__ __forceinline__ float2 at(const Row& w, int c) const {
    const bool live = c < live_cols;
    const long long off = c * cs;
    return make_float2((live && w.re_ok) ? to_f32(w.re[off]) : 0.0f,
                       (live && w.im_ok) ? to_f32(w.im[off]) : 0.0f);
  }

  // element (row r of the block, column c) of the pair, zero outside
  __device__ __forceinline__ float2 get(int r, int c) const { return at(row(r), c); }

  // elements c .. c + W - 1 of a row, zero outside: float32 rows read as
  // 16-byte vectors (8-byte for W = 2), bfloat16 rows 8 values a 16-byte
  // vector (8-, 4-byte for W = 4, 2), where they are contiguous, aligned
  // and live over the W columns, else element by element
  template <int W>
  __device__ __forceinline__ void vec(const Row& w, int c, float* xr, float* xi) const {
    if constexpr (std::is_same<T, float>::value) {
      constexpr int V = W < 4 ? W : 4;
      const float* pr = w.re + c;
      const float* pi = w.im_ok ? w.im + c : nullptr;
      if (cs == 1 && c + W <= live_cols &&
          ((reinterpret_cast<uintptr_t>(pr) | reinterpret_cast<uintptr_t>(pi)) & (4 * V - 1)) == 0) {
#pragma unroll
        for (int v = 0; v < W; v += V) {
          load_vec<V>(w.re_ok ? pr + v : nullptr, xr + v);
          load_vec<V>(w.im_ok ? pi + v : nullptr, xi + v);
        }
        return;
      }
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      constexpr int V = W < 8 ? W : 8;
      const __nv_bfloat16* pr = w.re + c;
      const __nv_bfloat16* pi = w.im_ok ? w.im + c : nullptr;
      if (cs == 1 && c + W <= live_cols &&
          ((reinterpret_cast<uintptr_t>(pr) | reinterpret_cast<uintptr_t>(pi)) & (2 * V - 1)) == 0) {
#pragma unroll
        for (int v = 0; v < W; v += V) {
          load_bf16<V>(w.re_ok ? pr + v : nullptr, xr + v);
          load_bf16<V>(w.im_ok ? pi + v : nullptr, xi + v);
        }
        return;
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float2 v = at(w, c + e);
      xr[e] = v.x;
      xi[e] = v.y;
    }
  }

 private:
  // V floats from p (16- or 8-byte aligned), zeros for a null p
  template <int V>
  __device__ __forceinline__ static void load_vec(const float* p, float* x) {
    if (p == nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.0f;
    } else if constexpr (V == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else if constexpr (V == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      x[0] = v.x;
      x[1] = v.y;
    } else {
      x[0] = __ldg(p);
    }
  }

  // V bfloat16 values from p (2V-byte aligned) widened, zeros for a null p
  template <int V>
  __device__ __forceinline__ static void load_bf16(const __nv_bfloat16* p, float* x) {
    if (p == nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.0f;
      return;
    }
    uint32_t w[(V + 1) / 2];
    if constexpr (V == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (V == 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (V == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      x[0] = __bfloat162float(p[0]);
      return;
    }
    // a bfloat16 is the upper half of its float32
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
};
