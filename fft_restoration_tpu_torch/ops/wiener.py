"""Elementwise frequency-domain filters on SoA (re, im) planes.

Counterpart of fft_restoration_tpu/ops/wiener.py (wiener_filter,
inverse_filter, cls_filter), expression for expression, and of the
spectral multiply of its models/convolve.py (`spectral_product`).

With G = gr + i*gi, H = hr + i*hi:
    G * conj(H) = (gr*hr + gi*hi) + i*(gi*hr - gr*hi)
    G * H       = (gr*hr - gi*hi) + i*(gr*hi + gi*hr)
H (and P) broadcast over G's leading axes.

A bfloat16 H (bf16 staging's cached spectrum, models/pipeline.py) is
computed as the JAX package's filters are under jit on a CPU: each square
of |H|^2 rounds to bfloat16 (the operation is bfloat16), their sum stays
float32 (XLA keeps that excess precision in the fused loop), and the
inverse filter's 1 / |H|^2 rounds to bfloat16 after rounding |H|^2 to it;
every product with G is float32 (`_mag2`, tests/test_torch_stage.py).
"""

from __future__ import annotations

import torch


def wiener_filter(G, H, K):
    """F = G * conj(H) / (|H|^2 + K)."""
    gr, gi = G
    hr, hi = H
    inv = 1.0 / (hr * hr + hi * hi + K)
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def _mag2(hr, hi):
    """|H|^2; for a bfloat16 H the squares round to bfloat16 and their sum
    is float32 (module docstring)."""
    if hr.dtype == torch.bfloat16:
        return (hr * hr).float() + (hi * hi).float()
    return hr * hr + hi * hi


def inverse_filter(G, H, eps=1e-8):
    """Direct inverse filter F = G / H, zero where |H|^2 <= eps."""
    gr, gi = G
    hr, hi = H
    mag2 = _mag2(hr, hi)
    safe = mag2 > eps
    if hr.dtype == torch.bfloat16:
        mag2 = mag2.to(torch.bfloat16)
    inv = torch.where(safe, 1.0 / torch.where(safe, mag2, torch.ones_like(mag2)),
                      torch.zeros_like(mag2))
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def cls_filter(G, H, P, gamma):
    """Constrained least squares: F = G * conj(H) / (|H|^2 + gamma*|P|^2)."""
    gr, gi = G
    hr, hi = H
    pr, pi = P
    inv = 1.0 / (_mag2(hr, hi) + gamma * (pr * pr + pi * pi))
    return (gr * hr + gi * hi) * inv, (gi * hr - gr * hi) * inv


def spectral_product(G, H, conj=False):
    """G * H, or G * conj(H) with conj=True (the JAX package multiplies by
    (hr, -hi): the same values, since negation is exact)."""
    gr, gi = G
    hr, hi = H
    if conj:
        return gr * hr + gi * hi, gi * hr - gr * hi
    return gr * hr - gi * hi, gr * hi + gi * hr
