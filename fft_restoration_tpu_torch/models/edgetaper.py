"""Edge tapering on the device: blend the frame toward its circular blur.

Counterpart of fft_restoration_tpu/models/edgetaper.py:
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
from fft_restoration_tpu_torch.models.pipeline import KERNEL_OPS
from fft_restoration_tpu_torch.ops.kernels import u8_to_unit


def edge_taper_planes(channels, psf, live_hw, *, psf_spectrum=None, ops=KERNEL_OPS,
                      radices_hw=((), ())):
    """Taper (C, Hp, Wp) zero-padded float32 (or uint8, converted x / 255)
    planes whose live image is the top-left live_hw = (h, w) extent.
    Returns float32 planes of the same shape, ready for the restore's
    forward FFT. psf_spectrum: the cached spectrum of `psf`
    (models.pipeline.psf_spectrum_planes), computed here when None.
    radices_hw: (rad_h, rad_w) of smooth (Hp, Wp) extents."""
    if channels.ndim != 3:
        raise ValueError(f"need (C, Hp, Wp) planes, got shape {tuple(channels.shape)}")
    if channels.dtype == torch.uint8:
        channels = u8_to_unit(channels)
    c, hp, wp = channels.shape
    h, w = live_hw
    wy, wx = (torch.from_numpy(v).to(channels.device)
              for v in taper_windows(h, w, hp, wp, psf.shape[-1]))
    alpha = wy[:, None] * wx[None, :]
    conv = circular_conv_builder(psf, hp, wp, psf_spectrum=psf_spectrum, ops=ops,
                                 radices_hw=radices_hw)
    if c >= 2:
        b_re, b_im = conv(channels[0::2], channels[1::2])
        blurred = unpack_pairs(b_re, b_im, c)
    else:
        blurred, _ = conv(channels, None)
    return alpha * channels + (1.0 - alpha) * blurred
