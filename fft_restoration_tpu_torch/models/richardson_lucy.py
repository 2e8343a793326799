"""Richardson-Lucy iterative deconvolution on the device.

Counterpart of fft_restoration_tpu/models/richardson_lucy.py, on the
kernel route and (fft_backend=, the JAX default 'matmul') the generic one:

    x_{k+1} = max(x_k * C(psf_mirrored, y / (C(psf, x_k) + eps)), 0)

with C the circular convolution of models/convolve.py: on the kernel
route three kernel launches per conv at column lengths >= 512 (B1, B2
'conv', B6), two convs per iteration, the mirrored one through conj(H);
on the generic route two fft2d calls and a spectral product per conv. The JAX
fori_loop is a host loop here: PyTorch runs eagerly, so each iteration
enqueues its ~6 launches and ~8 small tensor ops (a CUDA graph is a
later step). The PSF spectrum is computed once, or comes from the
pipeline's cache.

Channels ride complex pairs: the convs are linear and RL's nonlinear
steps (divide, multiply, max) are plane-wise, so re and im stay two
independent real channels through the whole loop. The divisions amplify
any float32 rounding difference between equivalent transforms: after a
few iterations two correct implementations sit ~1e-2 plane INF apart,
so RL is held to uint8-level or 5e-2 plane INF contracts (as in the JAX
package), not to the one-shot filters' 1e-5. The JAX operation order is
kept (scale after the inverse, eps added before the divide) so the drift
stays at that level.

Ranges and counters (utils/trace_profile.py, kept only while a profiler
records): each iteration opens `fphase_rl_iteration` and counts
`rl_iterations`; each of its two convolutions opens `fphase_rl_conv`
inside it and counts `rl_convs`. A device row belongs to the innermost
range, so the convolutions' kernels read as rl_conv and the elementwise
update (divide, multiply, clamp) as rl_iteration: 3 records an
iteration, 30 a request at 10 iterations.
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.models.convolve import (
    circular_conv_builder,
    pack_pairs,
    unpack_pairs,
)
from fft_restoration_tpu_torch.models.pipeline import KERNEL_BACKEND, KERNEL_OPS
from fft_restoration_tpu_torch.ops.kernels import u8_to_unit
from fft_restoration_tpu_torch.utils.trace_profile import count, fphase


def richardson_lucy_planes(channels, psf, n_iters: int = 10, *, eps: float = 1e-6,
                           fft_backend: str = KERNEL_BACKEND, radices_hw=((), ()),
                           psf_spectrum=None, ops=KERNEL_OPS, fft_engine=None,
                           mxu_precision=None):
    """RL-deconvolve (..., Hp, Wp) padded planes (float32 in [0, 1], or
    uint8 converted by exact division x / 255) with the (S, S) PSF.
    Returns float32 planes of the same shape clipped to [0, 1] (not
    min-max normalized: RL preserves flux, and a stretch would let the
    boundary-ringing spikes darken the whole frame).

    The planes are flattened to (N, Hp, Wp) and paired in that order
    (pack_pairs; JAX pairs along axis -3, which is the same order for
    one frame's (C, Hp, Wp) and differs only in rounding otherwise).
    fft_backend: 'pallas' (default, the kernels; the JAX package's default
    is 'matmul') or another backend of ops/fft.py (the generic route,
    models/convolve.py). radices_hw: (rad_h, rad_w) of smooth (Hp, Wp)
    extents (kernel route). psf_spectrum: the spectrum in the route's
    layout (circular_conv_builder), made here when None. ops: KERNEL_OPS
    or PLAIN_OPS (kernel route); fft_engine, mxu_precision: `ops` at that
    engine (circular_conv_builder). JAX's psf_rows is not taken: the port's
    spectrum transforms the PSF's own S rows already."""
    if channels.dtype == torch.uint8:
        channels = u8_to_unit(channels)
    hp, wp = channels.shape[-2:]
    conv = circular_conv_builder(psf, hp, wp, fft_backend=fft_backend,
                                 psf_spectrum=psf_spectrum, ops=ops, radices_hw=radices_hw,
                                 fft_engine=fft_engine, mxu_precision=mxu_precision)
    flat = channels.reshape(-1, hp, wp)
    y_re, y_im = pack_pairs(flat)

    def traced_conv(re, im, conj=False):
        with fphase("rl_conv"):
            count("rl_convs")
            return conv(re, im, conj=conj)

    x_re, x_im = y_re, y_im
    for _ in range(n_iters):
        with fphase("rl_iteration"):
            count("rl_iterations")
            d_re, d_im = traced_conv(x_re, x_im)
            r_re = y_re / (d_re + eps)
            r_im = y_im / (d_im + eps)
            g_re, g_im = traced_conv(r_re, r_im, conj=True)
            x_re = torch.clamp_min(x_re * g_re, 0.0)
            x_im = torch.clamp_min(x_im * g_im, 0.0)
    restored = unpack_pairs(x_re, x_im, flat.shape[0])
    return torch.clamp(restored.reshape(channels.shape), 0.0, 1.0)
