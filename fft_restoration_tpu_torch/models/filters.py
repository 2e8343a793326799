"""Restoration filter family on natural-order spectra.

Counterpart of fft_restoration_tpu/models/filters.py: each entry maps SoA
(G, H, params) -> F in the frequency domain (ops/wiener.py). The generic
route of models/pipeline.py (`fft_backend` other than 'pallas') calls
`apply_filter`; CLS's Laplacian spectrum is made here with the same
`fft2d` backend, as in JAX. (The kernel route has its own Laplacian
spectrum, in its bit-reversed transposed layout: pipeline.laplacian_spectrum.)
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.ops.fft import fft2d
from fft_restoration_tpu_torch.ops.wiener import cls_filter, inverse_filter, wiener_filter


def _laplacian_fft(shape, backend: str, device):
    """FFT of the corner-anchored 3x3 Laplacian regularizer, for CLS."""
    lap = torch.zeros(shape, dtype=torch.float32, device=device)
    lap[0, 0] = 4.0
    lap[0, 1] = lap[1, 0] = lap[0, -1] = lap[-1, 0] = -1.0
    return fft2d(lap, torch.zeros_like(lap), backend=backend)


def apply_filter(name: str, G, H, K, backend: str = "radix2"):
    if name == "wiener":
        return wiener_filter(G, H, K)
    if name == "inverse":
        return inverse_filter(G, H)
    if name == "cls":
        P = _laplacian_fft(tuple(G[0].shape[-2:]), backend, G[0].device)
        return cls_filter(G, H, P, K)
    raise ValueError(f"unknown filter {name!r}; one of {FILTERS}")


FILTERS = ("wiener", "inverse", "cls")
