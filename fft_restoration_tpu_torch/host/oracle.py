"""Serial numpy oracle of the Wiener restore, and its PSF family.

The semantic ground truth of the port, as fft_restoration_tpu/oracle/
serial.py is for the JAX package (same arithmetic, op for op):

  * complex64 throughout; radix-2 butterflies after a bit-reversal
    permutation, with per-stage twiddles from the float32 recurrence
    w *= wlen (not an exact table), so they drift as the reference's do;
  * unscaled inverse: the min-max normalize over the padded plane
    absorbs 1/(MN), then the plane is cropped;
  * |H|^2 as sqrt(re^2 + im^2)^2;
  * a non-pow2 axis (the `pad_to` extents of --pad smooth) takes the
    O(n^2) naive DFT with float32 angles and complex64 accumulation, as
    the reference's dft_naive_inplace does: its angle rounding puts up to
    ~1e-2 INF into the restored planes, so the port is held to it at the
    gpu tier there (and tightly to a float64 restore at the same extents).

The motion PSF is a horizontal line of 1/size through (size//2, size//2)
rotated with OpenCV getRotationMatrix2D + warpAffine (exact inverse-map
bilinear, constant-0 border), neither re-normalized nor fftshifted; the
gaussian and disk kernels are sum-normalized (JAX oracle/psf.py's
make_psf_oracle family, bit for bit).
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


def gaussian_kernel_oracle(size: int, sigma: float) -> np.ndarray:
    """(size, size) isotropic Gaussian PSF, sum-normalized, float32."""
    sigma = max(float(sigma), 1e-3)
    c = float(size // 2)
    x = np.arange(size, dtype=np.float32)[None, :] - c
    y = np.arange(size, dtype=np.float32)[:, None] - c
    g = np.exp(-(x * x + y * y) / np.float32(2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def disk_kernel_oracle(size: int) -> np.ndarray:
    """(size, size) defocus disk of diameter `size`, sum-normalized, with
    a linear antialiased rim, float32."""
    c = float(size // 2)
    r = size / 2.0
    x = np.arange(size, dtype=np.float32)[None, :] - c
    y = np.arange(size, dtype=np.float32)[:, None] - c
    w = np.clip(r + 0.5 - np.sqrt(x * x + y * y), 0.0, 1.0)
    return (w / w.sum()).astype(np.float32)


def make_psf_oracle(psf_type, size: int, param: float) -> np.ndarray:
    """PSF family on the host: 'motion' (param = angle in degrees),
    'gaussian' (param = sigma in px), 'disk' (param ignored), or a
    concrete (size, size) kernel array, passed through (--psf-file)."""
    if not isinstance(psf_type, str):
        kernel = np.asarray(psf_type, np.float32)
        if kernel.shape != (size, size):
            raise ValueError(f"custom PSF kernel shape {kernel.shape} != ({size}, {size})")
        return kernel
    if psf_type == "motion":
        return motion_psf(size, param)
    if psf_type == "gaussian":
        return gaussian_kernel_oracle(size, param)
    if psf_type == "disk":
        return disk_kernel_oracle(size)
    raise ValueError(f"unknown psf type {psf_type!r}")


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


def dft_naive(a: np.ndarray, inverse: bool) -> np.ndarray:
    """O(n^2) direct DFT over the last axis for any n: float32 angles,
    complex64 accumulation, unscaled inverse."""
    a = np.asarray(a, dtype=np.complex64)
    n = a.shape[-1]
    if n <= 1:
        return a
    sign = np.float32(1.0 if inverse else -1.0)
    k = np.arange(n, dtype=np.float32)[:, None]
    t = np.arange(n, dtype=np.float32)[None, :]
    ang = (np.float32(2.0 * math.pi) * k * t / np.float32(n) * sign).astype(np.float32)
    w = (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)
    return np.einsum("...t,kt->...k", a, w).astype(np.complex64)


def _transform_rows(a: np.ndarray, inverse: bool) -> np.ndarray:
    n = a.shape[-1]
    return _fft_radix2(a, inverse) if n & (n - 1) == 0 else dft_naive(a, inverse)


def _dft2d(a: np.ndarray, inverse: bool) -> np.ndarray:
    a = np.swapaxes(_transform_rows(a, inverse), -1, -2)
    return np.swapaxes(_transform_rows(a, inverse), -1, -2)


def _pad_to(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(a, [(0, rows - a.shape[-2]), (0, cols - a.shape[-1])])


def restore_channels(channels: np.ndarray, psf: np.ndarray, K: float = 0.01,
                     edgetaper: bool = False, pad_to=None) -> np.ndarray:
    """(C, H, W) float32 planes in [0, 1] -> restored (C, H, W) float32
    planes, each min-max normalized over its pow2-padded extent.
    edgetaper: pad, blend the padded frame toward its circular blur at
    the borders (host/edgetaper.py, float64), then restore the tapered
    padded planes and crop — the --edgetaper twin of the device path.
    pad_to: explicit (rows, cols) DFT extents in place of the pow2 pad
    (the --pad smooth parity target). As in the JAX oracle, a frame
    restored at pad_to extents without the taper is cropped before its
    min-max normalize, so its range is the frame's, not the padded
    plane's as on the device."""
    channels = np.asarray(channels, np.float32)
    h, w = channels.shape[-2:]
    if pad_to is not None:
        hp, wp = int(pad_to[0]), int(pad_to[1])
        if hp < h or wp < w:
            raise ValueError(f"pad_to {tuple(pad_to)} smaller than the image {(h, w)}")
    else:
        hp, wp = next_power_of_two(h), next_power_of_two(w)
    if edgetaper:
        from fft_restoration_tpu_torch.host.edgetaper import edge_taper_channels

        padded = np.zeros(channels.shape[:-2] + (hp, wp), np.float32)
        padded[..., :h, :w] = channels
        tapered = edge_taper_channels(padded, np.asarray(psf, np.float32), (h, w))
        return restore_channels(tapered, psf, K, pad_to=(hp, wp))[..., :h, :w]
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
        if pad_to is not None:
            restored = restored[:h, :w]
        lo, hi = restored.min(), restored.max()
        scale = np.float32(1.0) / np.float32(hi - lo) if hi > lo else np.float32(0.0)
        out.append(((restored - lo) * scale).astype(np.float32)[:h, :w])
    return np.stack(out, axis=0)


def normalize_over_frame(planes: np.ndarray) -> np.ndarray:
    """Min-max normalize (C, H, W) planes per channel over the frame: the
    device path's planes (normalized over the padded plane, then cropped)
    put on the normalization of an untapered pad_to restore, which is the
    frame's. The map is affine, so this compares the restores themselves."""
    p = np.asarray(planes, np.float64)
    lo = p.min(axis=(-2, -1), keepdims=True)
    hi = p.max(axis=(-2, -1), keepdims=True)
    return np.where(hi > lo, (p - lo) / np.where(hi > lo, hi - lo, 1.0), 0.0).astype(np.float32)


def restore_frame_channels(img_bgr: np.ndarray, psf_length: int, psf_angle: float,
                           K: float = 0.01, edgetaper: bool = False,
                           pad_to=None, psf_type="motion") -> np.ndarray:
    """uint8 BGR (H, W, 3) frame -> the oracle's restored (3, H, W) planes
    (at the pad_to extents when given) with the PSF of `psf_type` (a
    family name or a (psf_length, psf_length) kernel array)."""
    imgf = np.asarray(img_bgr, np.float32) / np.float32(255.0)
    psf = make_psf_oracle(psf_type, psf_length, psf_angle)
    return restore_channels(np.moveaxis(imgf, -1, 0), psf, K, edgetaper=edgetaper,
                            pad_to=pad_to)


def restore_image(img_bgr: np.ndarray, psf_length: int, psf_angle: float, K: float = 0.01,
                  edgetaper: bool = False, psf_type="motion") -> np.ndarray:
    """The serial whole-frame restore (JAX oracle/serial.restore_image):
    uint8 BGR (H, W, 3) -> restored uint8 BGR: the oracle's planes,
    merged, white balanced in Lab against the original frame
    (host/color.py), times 255 clipped and truncated."""
    from fft_restoration_tpu_torch.host.color import apply_white_balance, bgr_to_lab, lab_to_bgr

    img = np.asarray(img_bgr, np.float32) / np.float32(255.0)
    merged = np.moveaxis(restore_frame_channels(img_bgr, psf_length, psf_angle, K, edgetaper,
                                                None, psf_type), 0, -1)
    bgr = lab_to_bgr(apply_white_balance(bgr_to_lab(merged), bgr_to_lab(img)))
    return np.clip(bgr * np.float32(255.0), 0, 255).astype(np.uint8)
