"""Blurred test frames: the forward problem the restore inverts.

Per channel, in float64: the sum-normalized PSF (motion, gaussian or
disk, host/oracle.make_psf_oracle) centered in an
(H, W) plane and rolled to the corner (a shift-free circular
convolution), spectra multiplied, inverse transform, clip to uint8.
"""

from __future__ import annotations

import numpy as np

from fft_restoration_tpu_torch.host.oracle import make_psf_oracle


def blur_image(img_bgr: np.ndarray, psf_length: int, psf_angle: float,
               psf_type: str = "motion") -> np.ndarray:
    """uint8 BGR (H, W, 3) -> blurred uint8 BGR (H, W, 3); psf_type
    'motion', 'gaussian' (psf_angle is the sigma) or 'disk'."""
    img = np.asarray(img_bgr, np.float64)
    h, w = img.shape[:2]
    psf = make_psf_oracle(psf_type, psf_length, psf_angle).astype(np.float64)
    s = psf.sum()
    if s != 0:
        psf = psf / s
    full = np.zeros((h, w))
    cy, cx = psf.shape[0] // 2, psf.shape[1] // 2
    top, left = h // 2 - cy, w // 2 - cx
    full[top:top + psf.shape[0], left:left + psf.shape[1]] = psf
    H = np.fft.fft2(np.roll(full, (-(h // 2), -(w // 2)), axis=(0, 1)))
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[..., c] = np.real(np.fft.ifft2(np.fft.fft2(img[..., c]) * H))
    return np.clip(out, 0, 255).astype(np.uint8)
