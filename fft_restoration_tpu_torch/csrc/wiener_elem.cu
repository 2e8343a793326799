// wiener_elem: the elementwise Wiener filter F = G * conj(H) / (|H|^2 + K).
//
// Replaces fft_restoration_tpu/ops/pallas/wiener.py:wiener_pallas (B9,
// "fftr_wiener_elem"): one pass over SoA planes G (C, M, N) with a PSF
// spectrum H (M, N) shared by every plane. H is indexed by the element's
// position in its plane, never copied per plane (the TPU kernel's H
// BlockSpec maps the row block only). The arithmetic is the JAX kernel's:
//   inv = 1 / (hr*hr + hi*hi + K);  fr = (gr*hr + gi*hi) * inv;
//   fi = (gi*hr - gr*hi) * inv
// with an IEEE division (the build has no --use_fast_math).
//
// What bounds it on the H100: bytes. Per element it reads G (8 B) and H
// (8 B, from L2 after the first plane) and writes F (8 B), ~12 flops: at
// (3, 2048, 2048) 67 MB of G, 34 MB of H and 67 MB of F, 50 us at 3.35
// TB/s against 0.8 us of float32 arithmetic. So the design is a plain
// streaming pass: 16-byte vector loads and stores (float4) when a plane's
// length is a multiple of 4 and every operand is 16-byte aligned, else one
// element a thread; a grid-stride loop over the C * M * N elements. A pure
// elementwise pass would serve as Triton too; CUDA keeps the build to one
// nvcc and the exact division under the kernel's own control.
#include <cuda_runtime.h>

__device__ __forceinline__ void wiener1(float gr, float gi, float hr, float hi,
                                        float K, float* fr, float* fi) {
  const float inv = 1.0f / (hr * hr + hi * hi + K);
  *fr = (gr * hr + gi * hi) * inv;
  *fi = (gi * hr - gr * hi) * inv;
}

// one element per index: e over total = C * plane elements
__global__ void wiener_elem_kernel(const float* __restrict__ gr,
                                   const float* __restrict__ gi,
                                   const float* __restrict__ hr,
                                   const float* __restrict__ hi, float K,
                                   float* __restrict__ fr,
                                   float* __restrict__ fi, long long total,
                                   long long plane) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long h = e % plane;
    wiener1(gr[e], gi[e], hr[h], hi[h], K, fr + e, fi + e);
  }
}

// four elements per index (plane % 4 == 0, 16-byte aligned operands):
// e4 over total / 4
__global__ void wiener_elem_vec4_kernel(const float4* __restrict__ gr,
                                        const float4* __restrict__ gi,
                                        const float4* __restrict__ hr,
                                        const float4* __restrict__ hi, float K,
                                        float4* __restrict__ fr,
                                        float4* __restrict__ fi, long long total4,
                                        long long plane4) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total4;
       e += (long long)gridDim.x * blockDim.x) {
    const long long h = e % plane4;
    const float4 a = gr[e], b = gi[e], c = hr[h], d = hi[h];
    float4 x, y;
    wiener1(a.x, b.x, c.x, d.x, K, &x.x, &y.x);
    wiener1(a.y, b.y, c.y, d.y, K, &x.y, &y.y);
    wiener1(a.z, b.z, c.z, d.z, K, &x.z, &y.z);
    wiener1(a.w, b.w, c.w, d.w, K, &x.w, &y.w);
    fr[e] = x;
    fi[e] = y;
  }
}

#define ELEM_THREADS 256
// enough blocks to fill 132 SMs many times over; the loop takes the rest
#define ELEM_MAX_BLOCKS (132 * 32)

static int grid_for(long long n) {
  long long b = (n + ELEM_THREADS - 1) / ELEM_THREADS;
  return (int)(b < ELEM_MAX_BLOCKS ? (b > 0 ? b : 1) : ELEM_MAX_BLOCKS);
}

// C planes of `plane` elements; vec4 != 0: the float4 instance (the
// caller checked plane % 4 == 0 and the alignment)
extern "C" int wiener_elem_launch(const void* gr, const void* gi, const void* hr,
                                  const void* hi, float K, void* fr, void* fi,
                                  long long C, long long plane, int vec4,
                                  void* stream) {
  const long long total = C * plane;
  cudaStream_t s = (cudaStream_t)stream;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  if (vec4) {
    if (plane % 4) return (int)cudaErrorInvalidValue;
    wiener_elem_vec4_kernel<<<grid_for(total / 4), ELEM_THREADS, 0, s>>>(
        (const float4*)gr, (const float4*)gi, (const float4*)hr,
        (const float4*)hi, K, (float4*)fr, (float4*)fi, total / 4, plane / 4);
  } else {
    wiener_elem_kernel<<<grid_for(total), ELEM_THREADS, 0, s>>>(
        (const float*)gr, (const float*)gi, (const float*)hr, (const float*)hi,
        K, (float*)fr, (float*)fi, total, plane);
  }
  return (int)cudaGetLastError();
}
