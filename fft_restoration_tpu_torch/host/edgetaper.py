"""Edge tapering on the host, the serial oracle's side.

Counterpart of fft_restoration_tpu/oracle/edgetaper.py: tapered =
alpha * x + (1 - alpha) * blur(x), alpha the window of host/taper.py and
blur the circular convolution with the corner-anchored PSF, computed
with np.fft in float64 (the oracle's accuracy convention).
`host/oracle.py:restore_channels(..., edgetaper=True)` runs it before
the per-channel Wiener restore.
"""

from __future__ import annotations

import numpy as np

from fft_restoration_tpu_torch.host.taper import taper_windows


def edge_taper_channels(channels_padded, psf, live_hw) -> np.ndarray:
    """Taper (C, Hp, Wp) zero-padded float32 planes whose live image is
    the top-left live_hw = (h, w) extent."""
    x = np.asarray(channels_padded, np.float64)
    hp, wp = x.shape[-2:]
    h, w = live_hw
    wy, wx = taper_windows(h, w, hp, wp, psf.shape[-1])
    alpha = wy.astype(np.float64)[:, None] * wx.astype(np.float64)[None, :]

    pp = np.zeros((hp, wp), np.float64)
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    blurred = np.real(np.fft.ifft2(np.fft.fft2(x, axes=(-2, -1)) * H, axes=(-2, -1)))
    return (alpha * x + (1.0 - alpha) * blurred).astype(np.float32)
