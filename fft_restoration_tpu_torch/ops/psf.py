"""PSF synthesis on tensors.

Counterpart of fft_restoration_tpu/ops/psf.py: the motion-blur kernel
(utils.hpp:15-24 of the reference) — a horizontal line of 1/size through
(size//2, size//2), rotated by a getRotationMatrix2D affine with exact
inverse-map bilinear sampling (constant-0 border), not re-normalized —
matching the oracle (fft_restoration_tpu/oracle/psf.py) to float
rounding; and the gaussian and disk members of the family. Loading a
PSF from a file waits for its slice (ROADMAP.md A2).
"""

from __future__ import annotations

import math

import torch

PSF_TYPES = ("motion", "gaussian", "disk")


def motion_blur_kernel(size: int, angle_deg: float, device) -> torch.Tensor:
    """(size, size) float32 motion PSF on `device`."""
    f32 = dict(dtype=torch.float32, device=device)
    angle = torch.tensor(angle_deg, **f32) * torch.tensor(math.pi / 180.0, **f32)
    alpha = torch.cos(angle)
    beta = torch.sin(angle)
    cx = cy = torch.tensor(float(size // 2), **f32)

    # forward affine [[a, b, (1-a)cx - b*cy], [-b, a, b*cx + (1-a)cy]];
    # warpAffine samples the source through its inverse
    m02 = (1.0 - alpha) * cx - beta * cy
    m12 = beta * cx + (1.0 - alpha) * cy
    det = alpha * alpha + beta * beta
    d = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    i00 = alpha * d
    i01 = -beta * d
    i10 = beta * d
    i11 = alpha * d
    i02 = -(i00 * m02 + i01 * m12)
    i12 = -(i10 * m02 + i11 * m12)

    x = torch.arange(size, **f32)[None, :]
    y = torch.arange(size, **f32)[:, None]
    sx = i00 * x + i01 * y + i02
    sy = i10 * x + i11 * y + i12
    xi = torch.floor(sx)
    yi = torch.floor(sy)
    fx = sx - xi
    fy = sy - yi
    xi = xi.to(torch.int32)
    yi = yi.to(torch.int32)

    # the source is one horizontal line: src[r, c] = 1/size iff r == size//2
    line_row = size // 2
    val = torch.tensor(1.0 / size, **f32)
    zero = torch.zeros((), **f32)

    def sample(row_idx, col_idx):
        ok = (row_idx == line_row) & (col_idx >= 0) & (col_idx < size)
        return torch.where(ok, val, zero)

    s00 = sample(yi, xi)
    s01 = sample(yi, xi + 1)
    s10 = sample(yi + 1, xi)
    s11 = sample(yi + 1, xi + 1)
    wx0 = 1.0 - fx
    wy0 = 1.0 - fy
    return s00 * (wy0 * wx0) + s01 * (wy0 * fx) + s10 * (fy * wx0) + s11 * (fy * fx)


def gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    """(size, size) isotropic Gaussian PSF, sum-normalized."""
    f32 = dict(dtype=torch.float32, device=device)
    sigma = torch.clamp(torch.tensor(float(sigma), **f32), min=1e-3)
    c = float(size // 2)
    x = torch.arange(size, **f32)[None, :] - c
    y = torch.arange(size, **f32)[:, None] - c
    g = torch.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return g / g.sum()


def disk_kernel(size: int, device) -> torch.Tensor:
    """(size, size) defocus disk of diameter `size`, sum-normalized, with
    a linear antialiased rim."""
    f32 = dict(dtype=torch.float32, device=device)
    c = float(size // 2)
    r = size / 2.0
    x = torch.arange(size, **f32)[None, :] - c
    y = torch.arange(size, **f32)[:, None] - c
    w = torch.clamp(r + 0.5 - torch.sqrt(x * x + y * y), 0.0, 1.0)
    return w / w.sum()


def make_psf(psf_type: str, size: int, param: float, device) -> torch.Tensor:
    """PSF family dispatcher: 'motion' (param = angle in degrees),
    'gaussian' (param = sigma in px), 'disk' (param ignored)."""
    if psf_type == "motion":
        return motion_blur_kernel(size, param, device)
    if psf_type == "gaussian":
        return gaussian_kernel(size, param, device)
    if psf_type == "disk":
        return disk_kernel(size, device)
    raise ValueError(f"unknown psf type {psf_type!r}; one of {PSF_TYPES}")
