"""Elementwise Wiener filter on SoA (re, im) planes.

Counterpart of fft_restoration_tpu/ops/wiener.py:wiener_filter; the
inverse and CLS filters wait for their slice (ROADMAP.md A8).

With G = gr + i*gi, H = hr + i*hi:
    F = G * conj(H) / (|H|^2 + K)
      = ((gr*hr + gi*hi) + i*(gi*hr - gr*hi)) / (hr^2 + hi^2 + K)
"""

from __future__ import annotations


def wiener_filter(G, H, K):
    """F = G * conj(H) / (|H|^2 + K); H broadcasts over G's leading axes."""
    gr, gi = G
    hr, hi = H
    inv = 1.0 / (hr * hr + hi * hi + K)
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv
