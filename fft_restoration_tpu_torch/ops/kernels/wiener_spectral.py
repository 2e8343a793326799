"""Fused spectral middle (B2) — wrapper and plain version.

Counterpart of fft_restoration_tpu/ops/pallas/wiener_spectral.py:
wiener_spectral_rows_t in its 'wiener' mode: per row block of the
transposed, row-FFT'd planes, the column FFT (DIF), the Wiener filter
against the matching rows of the PSF spectrum, the column IFFT (DIT) and
a transposed write (csrc/wiener_spectral.cu). The 'conv' mode waits for
the convolve / Richardson-Lucy slices.
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda
from fft_restoration_tpu_torch.ops.kernels.fft_kernel import (
    check_kernel_length,
    rows_per_block,
    run_stages,
    tables,
)
from fft_restoration_tpu_torch.ops.wiener import wiener_filter


def _check(a_re, a_im, h_re, h_im):
    if a_re.ndim != 3 or a_im.shape != a_re.shape:
        raise ValueError(f"need matching (P, M, N) planes, got {tuple(a_re.shape)}")
    if h_re.shape != a_re.shape[1:] or h_im.shape != h_re.shape:
        raise ValueError(
            f"PSF spectrum {tuple(h_re.shape)} does not match planes {tuple(a_re.shape)}"
        )
    for t in (a_re, a_im, h_re, h_im):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("planes and spectrum must be contiguous float32")
    m, n = h_re.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"power-of-two length required, got {n}")
    if m % rows_per_block(n, m):
        raise ValueError(f"plane height {m} must be a multiple of the row block")


def wiener_spectral_t_plain(a_re, a_im, h_re, h_im, K):
    """Plain version of `wiener_spectral_t` (same signature and layout)."""
    _check(a_re, a_im, h_re, h_im)
    g = run_stages(a_re, a_im, inverse=False)
    f = wiener_filter(g, (h_re, h_im), K)
    r_re, r_im = run_stages(f[0], f[1], inverse=True)
    return r_re.transpose(1, 2).contiguous(), r_im.transpose(1, 2).contiguous()


def wiener_spectral_t(a_re, a_im, h_re, h_im, K):
    """colIFFT(wiener(colFFT(A), H)) with transposed writes.

    a_re, a_im: (P, M, N) contiguous float32 row-FFT'd planes in the
    transposed orientation, bit-reversed spectrum pending along N.
    h_re, h_im: (M, N) PSF spectrum in the same layout (psf_spectrum).
    Returns spatial-domain (P, N, M) float32 planes, unscaled, ready for
    the final row IFFT.
    """
    if not on_cuda(a_re, a_im, h_re, h_im):
        return wiener_spectral_t_plain(a_re, a_im, h_re, h_im, K)
    from fft_restoration_tpu_torch.ops.kernels import _build

    _check(a_re, a_im, h_re, h_im)
    planes, m, n = a_re.shape
    check_kernel_length(n)
    rows = rows_per_block(n, m)
    out_re = torch.empty((planes, n, m), dtype=torch.float32, device=a_re.device)
    out_im = torch.empty_like(out_re)
    lib = _build.load()
    cf, sf, _ = tables(n, False, a_re.device)
    ci, si, _ = tables(n, True, a_re.device)
    err = lib.wiener_spectral_t_launch(
        a_re.data_ptr(), a_im.data_ptr(), h_re.data_ptr(), h_im.data_ptr(),
        float(K), out_re.data_ptr(), out_im.data_ptr(), planes, m, n,
        n.bit_length() - 1, rows, cf.data_ptr(), sf.data_ptr(), ci.data_ptr(),
        si.data_ptr(), torch.cuda.current_stream(a_re.device).cuda_stream,
    )
    _build.check(err, "wiener_spectral_t")
    launch_counts["wiener_spectral_t"] += 1
    return out_re, out_im
