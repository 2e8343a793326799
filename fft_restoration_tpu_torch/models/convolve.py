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

The JAX package's natural-order backends (`_conv_planes_generic`) wait
for the port's fft2d backends (ROADMAP.md A3).
"""

from __future__ import annotations

import numpy as np
import torch

from fft_restoration_tpu_torch.models.pipeline import (
    FUSED_MIDDLE_MIN_N,
    KERNEL_OPS,
    psf_spectrum_planes,
)
from fft_restoration_tpu_torch.ops.wiener import spectral_product


def circular_conv_builder(psf, hp: int, wp: int, *, psf_spectrum=None, ops=KERNEL_OPS,
                          radices_hw=((), ())):
    """Build conv(re, im, conj=False) circularly convolving (P, hp, wp)
    planes (re float32, im float32 with at most P planes, the missing ones
    zero, or None; any strides fft_rows takes) with the corner-anchored PSF.
    Returns float32 (P, hp, wp) (re, im), scaled.

    psf_spectrum: the (wp, hp) spectrum planes of `psf_spectrum_planes`
    (the pipelines' cached one); computed here once when None.
    ops: KERNEL_OPS (the kernel wrappers) or PLAIN_OPS (their plain
    versions, the reference run on the card). radices_hw: (rad_h, rad_w)
    of smooth extents (models.pipeline.pad_extents)."""
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
