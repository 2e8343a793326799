"""User-supplied PSF kernels from files (--psf-file), on the host.

Counterpart of fft_restoration_tpu/ops/psf.py's load_psf_file, bit for
bit on the formats the port reads: .npy, .txt and .csv arrays, and
images in any format host/imageio.py decodes (averaged over the
channels), WebP, GIF, JPEG 2000, OpenEXR, fax TIFF and AVIF among them.
"""

from __future__ import annotations

import os

import numpy as np


def load_psf_file(path: str) -> np.ndarray:
    """A float32 (S, S) kernel from `path`: zero-padded square at the
    bottom/right (the corner-anchored pad convention keeps its alignment)
    and sum-normalized like every synthesized member of the family.
    Raises ValueError for a kernel that is not 2D, empty, non-finite,
    has negative lobes or sums to zero, and for an image format the port
    does not read; OSError when the file cannot be read."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        k = np.load(path)
    elif ext in (".txt", ".csv"):
        k = np.loadtxt(path, delimiter="," if ext == ".csv" else None)
    else:
        # an image in any format imread decodes, by its magic bytes, as
        # the JAX loader does
        from fft_restoration_tpu_torch.host.imageio import imread

        k = np.asarray(imread(path), np.float64).mean(axis=-1)
    k = np.atleast_2d(np.asarray(k, np.float64))
    if k.ndim != 2 or k.size == 0:
        raise ValueError(f"PSF file {path!r}: need a 2D kernel, got shape {k.shape}")
    if not np.isfinite(k).all():
        raise ValueError(f"PSF file {path!r}: kernel has non-finite values")
    # a PSF is a light-spread density: negative lobes (a Laplacian saved by
    # mistake) would corrupt RL's multiplicative updates; float noise just
    # below zero is clipped, real lobes are refused
    if k.min() < -1e-6 * max(k.max(), 0.0):
        raise ValueError(
            f"PSF file {path!r}: kernel has negative entries "
            f"(min {k.min():.3g}); a PSF must be non-negative"
        )
    k = np.clip(k, 0.0, None)
    s = max(k.shape)
    k = np.pad(k, ((0, s - k.shape[0]), (0, s - k.shape[1])))
    total = k.sum()
    if total <= 0:
        raise ValueError(f"PSF file {path!r}: kernel sum must be > 0")
    return (k / total).astype(np.float32)
