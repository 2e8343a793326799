"""Circular convolution with a PSF spectrum: the framework's blur model.

Counterpart of fft_restoration_tpu/models/convolve.py on its pallas path
(`_conv_planes_pallas`). The edge taper (models/edgetaper.py) and
Richardson-Lucy (models/richardson_lucy.py) are built on it.

conv(re, im) convolves two independent real planes riding one complex
transform (the channel-pair packing): the DFT is linear and H belongs to
a real PSF, so re and im come back as the two convolved channels. Per
call, at column length hp >= FUSED_MIDDLE_MIN_N (the JAX gate):

  fft_rows (B1)         row FFT, transposed store          (P, Wp, Hp)
  spectral_conv_t (B2)  column FFT -> * H -> column IFFT,
                        transposed store                   (P, Hp, Wp)
  fft_rows (B6)         row IFFT, natural store            (P, Hp, Wp)
  * 1/(hp*wp)           float32

Below the gate the middle is fft_rows forward (B6), the complex multiply
in plain torch (XLA computes it in the JAX package), then fft_rows'
inverse pass with transposed store. The spectrum stays in the kernels'
transposed, bit-reversed layout: the multiply is elementwise, so the
order cancels between the forward and the inverse transforms, and every
spatial result comes back in natural order. conv(..., conj=True)
multiplies by conj(H), the convolution with the mirrored PSF (the PSF
is real). At smooth extents (radices_hw) the row passes take rad_w and
the middle rad_h, as the restore's do.

On any other fft_backend (the generic route, JAX `_conv_planes_generic`)
the spectra are natural order: `fft2d` of the planes, the product with
the zero-padded PSF's `fft2d` spectrum (conjugated for the correlation),
the unscaled inverse `fft2d`, then * 1/(hp*wp). The matmul backend
factors smooth extents itself, so radices_hw is not needed there.
"""

from __future__ import annotations

import numpy as np
import torch

from fft_restoration_tpu_torch.models.pipeline import (
    FUSED_MIDDLE_MIN_N,
    KERNEL_BACKEND,
    KERNEL_OPS,
    psf_spectrum_planes,
    with_engine,
)
from fft_restoration_tpu_torch.ops.fft import check_backend, fft2d
from fft_restoration_tpu_torch.ops.wiener import spectral_product


def _conv_planes_generic(re, im, s_re, s_im, backend):
    """(P, hp, wp) planes convolved through the natural-order fft2d of
    `backend` with the spectrum (s_re, s_im); scaled by 1/(hp*wp). im
    has at most P planes (the missing ones zero) or is None, as on the
    kernel route."""
    hp, wp = re.shape[-2:]
    if im is None or im.shape[0] < re.shape[0]:
        full = re.new_zeros(re.shape)
        if im is not None:
            full[: im.shape[0]] = im
        im = full
    a_re, a_im = fft2d(re, im, False, backend)
    c_re = a_re * s_re - a_im * s_im
    c_im = a_re * s_im + a_im * s_re
    b_re, b_im = fft2d(c_re, c_im, True, backend)
    scale = float(np.float32(1.0 / (hp * wp)))
    return b_re * scale, b_im * scale


def circular_conv_builder(psf, hp: int, wp: int, *, fft_backend=KERNEL_BACKEND,
                          psf_spectrum=None, ops=KERNEL_OPS, radices_hw=((), ()),
                          fft_engine=None, mxu_precision=None):
    """Build conv(re, im, conj=False) circularly convolving planes with the
    corner-anchored PSF. Returns float32 (re, im) of re's shape, scaled.

    fft_backend 'pallas' (the kernel route): (P, hp, wp) planes, re
    float32 and im float32 with at most P planes (the missing ones zero)
    or None, any strides fft_rows takes; psf_spectrum is the (wp, hp)
    spectrum of `psf_spectrum_planes` (the pipelines' cached one), made
    here once when None; ops: KERNEL_OPS (the kernel wrappers) or
    PLAIN_OPS (their plain versions, the reference run on the card);
    radices_hw: (rad_h, rad_w) of smooth extents
    (models.pipeline.pad_extents); fft_engine, mxu_precision: `ops` at that
    engine (models.pipeline.with_engine: B1, B2 conv / conj and B6 take
    it; psf_spectrum must be the same engine's).
    Any other backend (the generic route): the same planes; psf_spectrum
    is the natural-order (hp, wp) fft2d spectrum of the zero-padded PSF,
    made here once when None."""
    check_backend(fft_backend)
    ops = with_engine(ops, fft_engine, mxu_precision)
    if fft_backend != KERNEL_BACKEND:
        if psf_spectrum is None:
            psf_pad = torch.zeros((hp, wp), dtype=torch.float32, device=psf.device)
            psf_pad[: psf.shape[0], : psf.shape[1]] = psf
            psf_spectrum = fft2d(psf_pad, torch.zeros_like(psf_pad), False, fft_backend)
        s_re, s_im = psf_spectrum

        def conv_generic(re, im, conj=False):
            return _conv_planes_generic(re, im, s_re, -s_im if conj else s_im, fft_backend)

        return conv_generic
    rad_h, rad_w = radices_hw
    h_re, h_im = (psf_spectrum if psf_spectrum is not None
                  else psf_spectrum_planes(psf, hp, wp, ops, radices_hw))
    scale = float(np.float32(1.0 / (hp * wp)))
    fused = hp >= FUSED_MIDDLE_MIN_N

    def conv(re, im, conj=False):
        a_re, a_im = ops.fft_rows(re, im, transposed=True, radices=rad_w)
        if fused:
            b_re, b_im = ops.spectral_conv_t(a_re, a_im, h_re, h_im, conj, rad_h)
        else:
            g = ops.fft_rows(a_re, a_im, radices=rad_h)
            c_re, c_im = spectral_product(g, (h_re, h_im), conj)
            b_re, b_im = ops.fft_rows(c_re, c_im, inverse=True, transposed=True, radices=rad_h)
        r_re, r_im = ops.fft_rows(b_re, b_im, inverse=True, radices=rad_w)
        return r_re * scale, r_im * scale

    return conv


def pack_pairs(planes):
    """(C, H, W) real planes -> (re, im) of ceil(C/2) planes each, plane
    2p as re and 2p + 1 as im, a zero im plane when C is odd (the JAX
    package's _pack_channel_pairs). Contiguous copies."""
    c = planes.shape[0]
    re = planes[0::2].contiguous()
    im = planes.new_zeros(re.shape)
    im[: c // 2] = planes[1::2]
    return re, im


def unpack_pairs(re, im, c: int):
    """Inverse of pack_pairs: (P, H, W) twice -> (C, H, W), channel order."""
    return torch.stack([re, im], dim=1).reshape((-1,) + tuple(re.shape[1:]))[:c]
