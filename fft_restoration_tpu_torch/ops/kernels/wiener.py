"""The elementwise Wiener filter (B9) — wrapper and plain version.

Counterpart of fft_restoration_tpu/ops/pallas/wiener.py:wiener_pallas:
F = G * conj(H) / (|H|^2 + K) over SoA planes G (..., M, N), one PSF
spectrum H (M, N) shared by the leading (channel/batch) axes. The kernel
(csrc/wiener_elem.cu) indexes H by the element's position in its plane,
so H is never copied per plane. No restore path calls it (the JAX
package's neither; its restore fuses the filter into the FFT kernels):
it is public `ops.kernels` API, as `wiener_pallas` is the JAX package's.
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda
from fft_restoration_tpu_torch.ops.wiener import wiener_filter


def _check(g_re, g_im, h_re, h_im):
    if g_re.ndim < 2 or g_im.shape != g_re.shape:
        raise ValueError(f"need matching (..., M, N) planes, got {tuple(g_re.shape)}")
    m, n = g_re.shape[-2:]
    for h in (h_re, h_im):
        if h.shape[-2:] != (m, n) or h.numel() != m * n:
            raise ValueError(f"H plane {tuple(h.shape)} doesn't match G {tuple(g_re.shape)}")
    for t in (g_re, g_im, h_re, h_im):
        if t.dtype != torch.float32:
            raise ValueError("planes and spectrum must be float32")


def wiener_elem_plain(g_re, g_im, h_re, h_im, K):
    """Plain version of `wiener_elem` (same signature and layout)."""
    _check(g_re, g_im, h_re, h_im)
    m, n = g_re.shape[-2:]
    return wiener_filter((g_re, g_im), (h_re.reshape(m, n), h_im.reshape(m, n)), K)


def wiener_elem(g_re, g_im, h_re, h_im, K):
    """F = G * conj(H) / (|H|^2 + K) (B9, the JAX wiener_pallas).

    g_re, g_im: (..., M, N) contiguous float32 planes; h_re, h_im: the (M,
    N) spectrum (any shape of M * N elements ending in (M, N)), shared by
    G's leading axes; K a scalar. Returns (F_re, F_im) shaped as G.
    """
    if not on_cuda(g_re, g_im, h_re, h_im):
        return wiener_elem_plain(g_re, g_im, h_re, h_im, K)
    from fft_restoration_tpu_torch.ops.kernels import _build

    _check(g_re, g_im, h_re, h_im)
    if not all(t.is_contiguous() for t in (g_re, g_im, h_re, h_im)):
        raise ValueError("planes and spectrum must be contiguous")
    m, n = g_re.shape[-2:]
    out_re, out_im = torch.empty_like(g_re), torch.empty_like(g_im)
    ops = (g_re, g_im, h_re, h_im, out_re, out_im)
    vec4 = (m * n) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ops)
    err = _build.load().wiener_elem_launch(
        g_re.data_ptr(), g_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(), float(K),
        out_re.data_ptr(), out_im.data_ptr(), g_re.numel() // (m * n), m * n, int(vec4),
        torch.cuda.current_stream(g_re.device).cuda_stream,
    )
    _build.check(err, "wiener_elem")
    launch_counts["wiener_elem"] += 1
    return out_re, out_im
