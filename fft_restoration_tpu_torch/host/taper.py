"""Edge-taper window (host-side numpy), shared by the device taper and
the oracle's.

Counterpart of fft_restoration_tpu/utils/taper.py, bit for bit: the
device taper (models/edgetaper.py) and the serial oracle's
(host/edgetaper.py) bake the same coefficients, so the CLI's oracle
verify holds with --edgetaper on both sides.

The window is separable: raised-cosine ramps of width
band = min(psf_side, (live - 1) // 2) at the four live-image borders, 1
in the interior, 0 in the DFT pad region (which the taper then fills
with the frame's own circular blur).
"""

from __future__ import annotations

import numpy as np


def taper_window_1d(n_live: int, n_pad: int, band: int) -> np.ndarray:
    """(n_pad,) float32: cosine ramp up over `band` samples, 1 in the
    middle, ramp down over `band`, 0 beyond n_live."""
    if n_pad < n_live:
        raise ValueError(f"pad extent {n_pad} < live extent {n_live}")
    b = int(min(band, max((n_live - 1) // 2, 0)))
    w = np.zeros(n_pad, np.float64)
    w[:n_live] = 1.0
    if b > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(b) + 0.5) / b)
        w[:b] = ramp
        w[n_live - b : n_live] = ramp[::-1]
    return w.astype(np.float32)


def taper_windows(h: int, w: int, hp: int, wp: int, psf_side: int):
    """The two 1D factors (wy, wx) of the window alpha = wy (x) wx for an
    (h, w) live image inside (hp, wp) DFT extents."""
    band = max(int(psf_side), 1)
    return taper_window_1d(h, hp, band), taper_window_1d(w, wp, band)
