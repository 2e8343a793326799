"""Edge tapering on the device: blend the frame toward its circular blur.

Counterpart of fft_restoration_tpu/models/edgetaper.py (kernel route,
and the generic one with fft_backend=):
tapered = alpha * x + (1 - alpha) * blur(x), alpha the separable window
of host/taper.py (the oracle's twin, host/edgetaper.py, bakes the same
coefficients) and blur the circular convolution of models/convolve.py.
Run before the forward FFT of a restore (--edgetaper), it removes the
wrap discontinuity that rings through the deconvolution of real photos;
in the DFT pad region alpha = 0, so the zero pad is replaced by the
blur's own smooth wrap tail — the pad rows are no longer zero, and the
restore's forward pass must transform all of them.

The blur rides the channel-pair packing: plane 2p is re, plane 2p + 1
im (a zero im plane when the count is odd), read by the first row pass
as strided views with no copy; pairs straddle images in a stack.
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.host.taper import taper_windows
from fft_restoration_tpu_torch.models.convolve import circular_conv_builder, unpack_pairs
from fft_restoration_tpu_torch.models.pipeline import KERNEL_BACKEND, KERNEL_OPS
from fft_restoration_tpu_torch.ops.kernels import u8_to_unit


def edge_taper_planes(channels, psf, live_hw, *, fft_backend: str = KERNEL_BACKEND,
                      radices_hw=((), ()), psf_spectrum=None, ops=KERNEL_OPS, fft_engine=None,
                      mxu_precision=None):
    """Taper (..., Hp, Wp) zero-padded float32 (or uint8, converted
    x / 255) planes whose live image is the top-left live_hw = (h, w)
    extent. Returns float32 planes of the same shape, ready for the
    restore's forward FFT.

    The planes are flattened to (N, Hp, Wp) and paired in that order,
    read as strided views (see richardson_lucy_planes). fft_backend:
    'pallas' (default, the kernels; the JAX package's default is
    'matmul') or another backend of ops/fft.py (the generic route).
    radices_hw: (rad_h, rad_w) of smooth (Hp, Wp) extents (kernel route).
    psf_spectrum: the cached spectrum of `psf` in the route's layout
    (circular_conv_builder), made here when None. ops: KERNEL_OPS or
    PLAIN_OPS (kernel route); fft_engine, mxu_precision: `ops` at that
    engine (circular_conv_builder)."""
    if channels.dtype == torch.uint8:
        channels = u8_to_unit(channels)
    hp, wp = channels.shape[-2:]
    h, w = live_hw
    wy, wx = (torch.from_numpy(v).to(channels.device)
              for v in taper_windows(h, w, hp, wp, psf.shape[-1]))
    alpha = wy[:, None] * wx[None, :]
    conv = circular_conv_builder(psf, hp, wp, fft_backend=fft_backend,
                                 psf_spectrum=psf_spectrum, ops=ops, radices_hw=radices_hw,
                                 fft_engine=fft_engine, mxu_precision=mxu_precision)
    flat = channels.reshape(-1, hp, wp)
    n = flat.shape[0]
    b_re, b_im = conv(flat[0::2], flat[1::2] if n >= 2 else None)
    blurred = unpack_pairs(b_re, b_im, n).reshape(channels.shape)
    return alpha * channels + (1.0 - alpha) * blurred
