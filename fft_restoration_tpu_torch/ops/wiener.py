"""Elementwise frequency-domain filters on SoA (re, im) planes.

Counterpart of fft_restoration_tpu/ops/wiener.py (wiener_filter,
inverse_filter, cls_filter), expression for expression, and of the
spectral multiply of its models/convolve.py (`spectral_product`).

With G = gr + i*gi, H = hr + i*hi:
    G * conj(H) = (gr*hr + gi*hi) + i*(gi*hr - gr*hi)
    G * H       = (gr*hr - gi*hi) + i*(gr*hi + gi*hr)
H (and P) broadcast over G's leading axes.
"""

from __future__ import annotations

import torch


def wiener_filter(G, H, K):
    """F = G * conj(H) / (|H|^2 + K)."""
    gr, gi = G
    hr, hi = H
    inv = 1.0 / (hr * hr + hi * hi + K)
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def inverse_filter(G, H, eps=1e-8):
    """Direct inverse filter F = G / H, zero where |H|^2 <= eps."""
    gr, gi = G
    hr, hi = H
    mag2 = hr * hr + hi * hi
    safe = mag2 > eps
    inv = torch.where(safe, 1.0 / torch.where(safe, mag2, torch.ones_like(mag2)),
                      torch.zeros_like(mag2))
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def cls_filter(G, H, P, gamma):
    """Constrained least squares: F = G * conj(H) / (|H|^2 + gamma*|P|^2)."""
    gr, gi = G
    hr, hi = H
    pr, pi = P
    inv = 1.0 / (hr * hr + hi * hi + gamma * (pr * pr + pi * pi))
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def spectral_product(G, H, conj=False):
    """G * H, or G * conj(H) with conj=True (the JAX package multiplies by
    (hr, -hi): the same values, since negation is exact)."""
    gr, gi = G
    hr, hi = H
    if conj:
        return gr * hr + gi * hi, gi * hr - gr * hi
    return gr * hr - gi * hi, gr * hi + gi * hr
