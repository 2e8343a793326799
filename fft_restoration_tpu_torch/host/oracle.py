"""Serial numpy oracle of the Wiener restore, and its motion PSF.

The semantic ground truth of the port, as fft_restoration_tpu/oracle/
serial.py is for the JAX package (same arithmetic, op for op):

  * complex64 throughout; radix-2 butterflies after a bit-reversal
    permutation, with per-stage twiddles from the float32 recurrence
    w *= wlen (not an exact table), so they drift as the reference's do;
  * unscaled inverse: the min-max normalize over the padded plane
    absorbs 1/(MN), then the plane is cropped;
  * |H|^2 as sqrt(re^2 + im^2)^2.

The motion PSF is a horizontal line of 1/size through (size//2, size//2)
rotated with OpenCV getRotationMatrix2D + warpAffine (exact inverse-map
bilinear, constant-0 border), neither re-normalized nor fftshifted.
"""

from __future__ import annotations

import math

import numpy as np

from fft_restoration_tpu_torch.host.padding import next_power_of_two


def motion_psf(size: int, angle_deg: float) -> np.ndarray:
    """(size, size) float32 motion-blur kernel, OpenCV semantics."""
    kernel = np.zeros((size, size), np.float32)
    c = size // 2
    kernel[c, :] = np.float32(1.0 / size)
    a = angle_deg * math.pi / 180.0
    alpha, beta = math.cos(a), math.sin(a)
    # getRotationMatrix2D about (c, c), then invertAffineTransform
    m = np.array([[alpha, beta, (1.0 - alpha) * c - beta * c],
                  [-beta, alpha, beta * c + (1.0 - alpha) * c]])
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0.0 else 0.0
    a11, a12, a21, a22 = m[1, 1] * d, -m[0, 1] * d, -m[1, 0] * d, m[0, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]

    x = np.arange(size, dtype=np.float64)[None, :]
    y = np.arange(size, dtype=np.float64)[:, None]
    sx = a11 * x + a12 * y + b1
    sy = a21 * x + a22 * y + b2
    xi = np.floor(sx).astype(np.int64)
    yi = np.floor(sy).astype(np.int64)
    fx = (sx - xi).astype(np.float32)
    fy = (sy - yi).astype(np.float32)

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < size) & (xx >= 0) & (xx < size)
        return np.where(valid, kernel[np.clip(yy, 0, size - 1), np.clip(xx, 0, size - 1)],
                        np.float32(0.0))

    wx0 = np.float32(1.0) - fx
    wy0 = np.float32(1.0) - fy
    return (sample(yi, xi) * (wy0 * wx0) + sample(yi, xi + 1) * (wy0 * fx)
            + sample(yi + 1, xi) * (fy * wx0) + sample(yi + 1, xi + 1) * (fy * fx)
            ).astype(np.float32)


def _fft_radix2(a: np.ndarray, inverse: bool) -> np.ndarray:
    """Unscaled radix-2 transform over the last axis (pow2 length)."""
    a = np.ascontiguousarray(a, dtype=np.complex64)
    n = a.shape[-1]
    if n <= 1:
        return a
    bits = n.bit_length() - 1
    perm = np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)])
    a = a[..., perm]
    length = 2
    while length <= n:
        half = length // 2
        ang = np.float32(2.0 * math.pi / length * (1.0 if inverse else -1.0))
        seq = np.full(half, np.complex64(complex(np.cos(ang), np.sin(ang))), np.complex64)
        seq[0] = 1.0
        w = np.cumprod(seq, dtype=np.complex64)  # the float32 recurrence w *= wlen
        blocks = a.reshape(a.shape[:-1] + (n // length, length))
        u = blocks[..., :half]
        v = (blocks[..., half:] * w).astype(np.complex64)
        a = np.concatenate([(u + v).astype(np.complex64), (u - v).astype(np.complex64)],
                           axis=-1).reshape(a.shape)
        length <<= 1
    return a


def _dft2d(a: np.ndarray, inverse: bool) -> np.ndarray:
    a = np.swapaxes(_fft_radix2(a, inverse), -1, -2)
    return np.swapaxes(_fft_radix2(a, inverse), -1, -2)


def _pad_to(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(a, [(0, rows - a.shape[-2]), (0, cols - a.shape[-1])])


def restore_channels(channels: np.ndarray, psf: np.ndarray, K: float = 0.01) -> np.ndarray:
    """(C, H, W) float32 planes in [0, 1] -> restored (C, H, W) float32
    planes, each min-max normalized over its pow2-padded extent."""
    channels = np.asarray(channels, np.float32)
    h, w = channels.shape[-2:]
    hp, wp = next_power_of_two(h), next_power_of_two(w)
    H = _dft2d(_pad_to(np.asarray(psf, np.float32), hp, wp).astype(np.complex64), False)
    mag = np.sqrt(H.real * H.real + H.imag * H.imag, dtype=np.float32)
    denom = (mag * mag + np.float32(K)).astype(np.float32)
    out = []
    for ch in channels:
        G = _dft2d(_pad_to(ch, hp, wp).astype(np.complex64), False)
        num_re = (G.real * H.real - G.imag * (-H.imag)).astype(np.float32)
        num_im = (G.real * (-H.imag) + G.imag * H.real).astype(np.float32)
        res = ((num_re / denom) + 1j * (num_im / denom)).astype(np.complex64)
        restored = _dft2d(res, True).real.astype(np.float32)
        lo, hi = restored.min(), restored.max()
        scale = np.float32(1.0) / np.float32(hi - lo) if hi > lo else np.float32(0.0)
        out.append(((restored - lo) * scale).astype(np.float32)[:h, :w])
    return np.stack(out, axis=0)


def restore_frame_channels(img_bgr: np.ndarray, psf_length: int, psf_angle: float,
                           K: float = 0.01) -> np.ndarray:
    """uint8 BGR (H, W, 3) frame -> the oracle's restored (3, H, W) planes."""
    imgf = np.asarray(img_bgr, np.float32) / np.float32(255.0)
    return restore_channels(np.moveaxis(imgf, -1, 0), motion_psf(psf_length, psf_angle), K)
