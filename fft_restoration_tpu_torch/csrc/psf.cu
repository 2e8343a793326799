// psf: the motion-blur PSF made on the card in one launch.
//
// Replaces no pallas_call: the JAX package makes the motion PSF with jnp
// ops (fft_restoration_tpu/ops/psf.py:motion_blur_kernel). It is a kernel
// because the plain version (ops/psf.py:motion_blur_kernel) is 108 small
// torch ops on the card, each its own launch and four of them blocking
// copies of a host scalar: ~2 ms of host for every new PSF. Here the
// scalars are arguments of the launch and nothing is copied.
//
// One thread makes one value of the (size, size) PSF: it computes the
// inverse of getRotationMatrix2D's affine from (size, angle) itself, then
// samples the one-row source (1/size on row size/2, 0 elsewhere)
// bilinearly at the inverse-mapped point. Every operation is the plain
// version's, in its order and in float32, so the PSF is the plain
// version's to the bit: precise cosf and sinf, an IEEE division, each
// product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// which nvcc never contracts into an FMA: torch's kernels round each op
// separately, where an FMA would round once), sums added left to right
// as the torch expression adds them.
//
// What bounds it on the H100: the launch. A PSF of size <= 60 is at most
// 3,600 values (14.4 KB), ~1.3 us on the device. At the largest size that
// _check_psf_fits allows, 4096, the per-thread affine and sincos (~150
// instructions a value) bound it: ~0.1 ms against 20 us of stores at
// 3.35 TB/s, for a PSF no cell makes.
#include <cuda_runtime.h>

#define PSF_THREADS 256

// the one-row source at (row, col): src[r, c] = 1/size iff r == size/2,
// with a constant-0 border
__device__ __forceinline__ float line_sample(int row, int col, int line, int size, float val) {
  return (row == line && col >= 0 && col < size) ? val : 0.0f;
}

// angle_deg: the angle in degrees as float32; val: 1/size as float32
__global__ void motion_psf_kernel(float* __restrict__ out, int size, float angle_deg, float val) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)size * size) return;
  const float x = (float)(e % size), y = (float)(e / size);

  const float angle = __fmul_rn(angle_deg, (float)(3.14159265358979323846 / 180.0));
  const float alpha = cosf(angle);
  const float beta = sinf(angle);
  const float cx = (float)(size / 2), cy = cx;
  const float one_a = __fsub_rn(1.0f, alpha);
  // forward affine [[a, b, (1-a)cx - b*cy], [-b, a, b*cx + (1-a)cy]];
  // warpAffine samples the source through its inverse
  const float m02 = __fsub_rn(__fmul_rn(one_a, cx), __fmul_rn(beta, cy));
  const float m12 = __fadd_rn(__fmul_rn(beta, cx), __fmul_rn(one_a, cy));
  const float det = __fadd_rn(__fmul_rn(alpha, alpha), __fmul_rn(beta, beta));
  const float d = det != 0.0f ? __fdiv_rn(1.0f, det) : 0.0f;
  const float i00 = __fmul_rn(alpha, d), i01 = __fmul_rn(-beta, d);
  const float i10 = __fmul_rn(beta, d), i11 = __fmul_rn(alpha, d);
  const float i02 = -__fadd_rn(__fmul_rn(i00, m02), __fmul_rn(i01, m12));
  const float i12 = -__fadd_rn(__fmul_rn(i10, m02), __fmul_rn(i11, m12));

  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(i00, x), __fmul_rn(i01, y)), i02);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(i10, x), __fmul_rn(i11, y)), i12);
  const float xf = floorf(sx), yf = floorf(sy);
  const float fx = __fsub_rn(sx, xf), fy = __fsub_rn(sy, yf);
  const int xi = (int)xf, yi = (int)yf;
  const int line = size / 2;
  const float s00 = line_sample(yi, xi, line, size, val);
  const float s01 = line_sample(yi, xi + 1, line, size, val);
  const float s10 = line_sample(yi + 1, xi, line, size, val);
  const float s11 = line_sample(yi + 1, xi + 1, line, size, val);
  const float wx0 = __fsub_rn(1.0f, fx), wy0 = __fsub_rn(1.0f, fy);
  float v = __fmul_rn(s00, __fmul_rn(wy0, wx0));
  v = __fadd_rn(v, __fmul_rn(s01, __fmul_rn(wy0, fx)));
  v = __fadd_rn(v, __fmul_rn(s10, __fmul_rn(fy, wx0)));
  out[e] = __fadd_rn(v, __fmul_rn(s11, __fmul_rn(fy, fx)));
}

// out: (size, size) float32; the scalars round to float32 on the host, as
// torch.tensor(angle_deg, dtype=float32) and torch.tensor(1.0 / size, ...)
// round them
extern "C" int motion_psf_launch(void* out, int size, double angle_deg, void* stream) {
  if (size < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)size * size;
  motion_psf_kernel<<<(unsigned)((n + PSF_THREADS - 1) / PSF_THREADS), PSF_THREADS, 0,
                      (cudaStream_t)stream>>>((float*)out, size, (float)angle_deg,
                                              (float)(1.0 / size));
  return (int)cudaGetLastError();
}
