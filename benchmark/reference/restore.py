"""The plain float64 reference of one Wiener restore, in torch.

What the benchmark holds the program's uint8 frames against. It follows
the reference C++ program (serial.cpp) and its README invocation, and
shares no code with the program:

  * the motion PSF: a horizontal line of 1/length through
    (length // 2, length // 2), rotated by the angle with the inverse map
    of OpenCV's getRotationMatrix2D and bilinear sampling with a zero
    border, not re-normalized;
  * the frame's channels x / 255, zero padded to the next power of two on
    each axis, the PSF anchored at the padded plane's corner;
  * F = G conj(H) / (|H|^2 + K), the inverse transform, and each channel
    min-max normalized over its padded plane, then cropped;
  * the Lab white balance: each frame's L scaled by mean L of the input
    over mean L of the restore (+1e-6), clipped to [0, 100], back to BGR,
    then trunc(clip(x * 255, 0, 255)) as uint8.

Every step is float64 on whatever device the frame lies on. Nothing here
imports the program. `prepare` and `restore` are this module's side of
the interface of a reference (reference/__init__.py), with K read from
the configuration.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
# sRGB (linear) -> XYZ, D65 white (OpenCV's Lab constants)
SRGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
D65 = (0.950456, 1.0, 1.088754)
T0 = 0.008856
KAPPA = 903.3
SLOPE = 7.787
OFFSET = 16.0 / 116.0


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def motion_psf(length: int, angle_deg: float, device) -> torch.Tensor:
    """(length, length) float64 motion PSF (module docstring)."""
    c = length // 2
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a), math.sin(a)
    # the forward affine about (c, c) and its inverse
    m02 = (1.0 - alpha) * c - beta * c
    m12 = beta * c + (1.0 - alpha) * c
    det = alpha * alpha + beta * beta
    inv = 1.0 / det if det != 0.0 else 0.0
    i00, i01, i10, i11 = alpha * inv, -beta * inv, beta * inv, alpha * inv
    i02 = -(i00 * m02 + i01 * m12)
    i12 = -(i10 * m02 + i11 * m12)
    x = torch.arange(length, dtype=F64, device=device)[None, :]
    y = torch.arange(length, dtype=F64, device=device)[:, None]
    sx = i00 * x + i01 * y + i02
    sy = i10 * x + i11 * y + i12
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0

    def src(yy, xx):
        # the source image: 1/length on row c, zero elsewhere and outside
        inside = (yy == c) & (xx >= 0) & (xx < length)
        return inside.to(F64) / length

    return (src(y0, x0) * (1 - fy) * (1 - fx) + src(y0, x0 + 1) * (1 - fy) * fx
            + src(y0 + 1, x0) * fy * (1 - fx) + src(y0 + 1, x0 + 1) * fy * fx)


def psf_spectrum(length: int, angle_deg: float, hp: int, wp: int, device) -> torch.Tensor:
    """Complex128 (hp, wp) spectrum of the corner-anchored PSF."""
    plane = torch.zeros((hp, wp), dtype=F64, device=device)
    plane[:length, :length] = motion_psf(length, angle_deg, device)
    return torch.fft.fft2(plane)


def _srgb_to_linear(x):
    x = x.clamp(0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(x):
    x = x.clamp(min=0.0)
    return torch.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1.0 / 2.4) - 0.055)


def _f(t):
    return torch.where(t > T0, t.clamp(min=0.0) ** (1.0 / 3.0), SLOPE * t + OFFSET)


def _f_inv(f):
    f3 = f * f * f
    return torch.where(f3 > T0, f3, (f - OFFSET) / SLOPE)


def _xyz(b, g, r):
    """(X / Xn, Y / Yn, Z / Zn) of BGR planes in [0, 1]."""
    lin = (_srgb_to_linear(r), _srgb_to_linear(g), _srgb_to_linear(b))
    return tuple(sum(m * v for m, v in zip(row, lin)) / wn for row, wn in zip(SRGB_TO_XYZ, D65))


def lab(b, g, r):
    x, y, z = _xyz(b, g, r)
    fx, fy, fz = _f(x), _f(y), _f(z)
    L = torch.where(y > T0, 116.0 * fy - 16.0, KAPPA * y)
    return L, 500.0 * (fx - fy), 200.0 * (fy - fz)


def lab_l(b, g, r):
    y = _xyz(b, g, r)[1]
    return torch.where(y > T0, 116.0 * _f(y) - 16.0, KAPPA * y)


def lab_to_bgr(L, a, bb):
    fy = (L + 16.0) / 116.0
    x = _f_inv(fy + a / 500.0) * D65[0]
    y = _f_inv(fy) * D65[1]
    z = _f_inv(fy - bb / 200.0) * D65[2]
    inv = torch.linalg.inv(torch.tensor(SRGB_TO_XYZ, dtype=F64))
    r, g, b = (inv[i, 0].item() * x + inv[i, 1].item() * y + inv[i, 2].item() * z
               for i in range(3))
    return tuple(_linear_to_srgb(v).clamp(0.0, 1.0) for v in (b, g, r))


def restore_planes(frame: torch.Tensor, H: torch.Tensor, K: float) -> torch.Tensor:
    """uint8 (h, w, 3) BGR frame and its complex128 (hp, wp) PSF spectrum
    -> (3, h, w) float64 restored planes in [0, 1]."""
    h, w, _ = frame.shape
    hp, wp = H.shape
    out = []
    filt = H.conj() / (H.real ** 2 + H.imag ** 2 + K)
    for ch in range(3):
        plane = torch.zeros((hp, wp), dtype=F64, device=frame.device)
        plane[:h, :w] = frame[..., ch].to(F64) / 255.0
        r = torch.fft.ifft2(torch.fft.fft2(plane) * filt).real
        lo, hi = r.min(), r.max()
        scale = 1.0 / (hi - lo) if hi > lo else torch.zeros((), dtype=F64, device=r.device)
        out.append(((r - lo) * scale)[:h, :w])
    return torch.stack(out)


def encode(planes: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """(3, h, w) restored planes and the uint8 input frame -> the white
    balanced uint8 (h, w, 3) BGR frame."""
    orig = frame.permute(2, 0, 1).to(F64) / 255.0
    gain = lab_l(*orig).mean() / (lab_l(*planes).mean() + 1e-6)
    L, a, bb = lab(*planes)
    bgr = lab_to_bgr((L * gain).clamp(0.0, 100.0), a, bb)
    return torch.stack([(v * 255.0).clamp(0.0, 255.0).trunc().to(torch.uint8) for v in bgr], -1)


def restore_frame(frame: torch.Tensor, length: int, angle_deg: float, K: float,
                  H: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 (h, w, 3) BGR frame -> the reference's restored uint8 frame
    (H: the PSF spectrum when the caller already has it)."""
    h, w, _ = frame.shape
    if H is None:
        H = psf_spectrum(length, angle_deg, next_pow2(h), next_pow2(w), frame.device)
    return encode(restore_planes(frame, H, K), frame)


def prepare(length: int, angle_deg: float, h: int, w: int, config: dict, device) -> torch.Tensor:
    """What every (h, w) frame of the PSF (length, angle) reuses: the PSF's
    spectrum at the next power of two on each axis."""
    return psf_spectrum(length, angle_deg, next_pow2(h), next_pow2(w), device)


def restore(frame: torch.Tensor, prepared: torch.Tensor, config: dict) -> torch.Tensor:
    """uint8 (h, w, 3) BGR frame -> the reference's restored uint8 frame,
    with the configuration's K."""
    return encode(restore_planes(frame, prepared, float(config["K"])), frame)
