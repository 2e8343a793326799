"""The SoA FFT API: `fft1d`/`fft2d` over float32 (re, im) planes.

Counterpart of fft_restoration_tpu/ops/fft.py, backend for backend. All
backends transform the LAST axis (fft1d) or the last two (fft2d) of
float32 `(re, im)` tensors of any equal leading shape, forward or
inverse, natural order in and out, with NO scaling on the inverse.

backends
--------
* ``radix2``  — iterative radix-2 Cooley-Tukey in plain torch, as the JAX
  backend is a plain jnp graph: the bit reversal as a log2(n)-dim reshape
  and axis-reversing permute, then log2(n) butterfly stages over
  contiguous reshapes, on float64-built float32 twiddle tables.
* ``matmul``  — the four-step FFT: n = n1 * n2 (`_split_factors`, any
  composite n), DFT matrices applied as float32 matrix products, the
  twiddle in between. JAX computes these einsums at HIGHEST precision
  outside any kernel, so here they are `torch.matmul` in true float32:
  on the card TF32 is switched off around them (`_full_float32`), since
  TF32 keeps ~3 decimal digits and would fail the oracle's l2 tier.
* ``naive``   — the O(n^2) DFT matrix (float64-built, cast to float32) as
  one complex matrix product; also what a non-pow2 n under ``radix2`` or
  ``pallas`` falls back to, as in JAX.
* ``xla``     — JAX's library cross-check backend is jnp.fft; the port's
  is torch.fft (cuFFT on the card), the inverse multiplied back by n.
  Taken only when a caller names it; no other route falls back to it.
* ``pallas``  — the hand-written kernel: fft_rows with natural ordering
  (B6's natural mode, ops/kernels/fft_kernel.py), the name kept so the
  backends are the JAX package's. On CPU tensors it runs the kernel's
  plain version.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import numpy as np
import torch

from fft_restoration_tpu_torch.ops.kernels.fft_kernel import bit_reverse_last_axis, fft_rows

FFT_BACKENDS = ("radix2", "matmul", "naive", "xla", "pallas")


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


# ---------------------------------------------------------------------------
# twiddle / DFT-matrix tables (host-side float64, cast once to float32)


@functools.lru_cache(maxsize=None)
def _stage_twiddle_np(length: int, inverse: bool) -> tuple:
    """Exact twiddles (cos, sin) for w^k, k < length/2, one radix-2 stage."""
    sign = 1.0 if inverse else -1.0
    k = np.arange(length // 2, dtype=np.float64)
    ang = sign * 2.0 * math.pi * k / length
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, inverse: bool) -> tuple:
    """Dense DFT matrix W[k,t] = exp(sign*2pi*i*k*t/n) as (re, im) f32."""
    sign = 1.0 if inverse else -1.0
    k = np.arange(n, dtype=np.float64)
    ang = sign * 2.0 * math.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _four_step_twiddle_np(n1: int, n2: int, inverse: bool) -> tuple:
    """T[k1, j2] = exp(sign*2pi*i*k1*j2/(n1*n2)) as (re, im) f32."""
    n = n1 * n2
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    ang = sign * 2.0 * math.pi * np.outer(k1, j2) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on(device: torch.device, table, *args) -> tuple:
    """A host table function's (re, im) planes on `device`, uploaded once."""
    return tuple(torch.from_numpy(a).to(device) for a in table(*args))


def _split_factors(n: int) -> tuple:
    """n = n1 * n2, as square as possible (minimal n1 + n2), for ANY
    composite n (e.g. 3840 = 64 * 60); (n, 1) when n is prime (the caller
    falls back to the naive DFT matmul)."""
    best = (n, 1)
    d = int(math.isqrt(n))
    while d >= 2:
        if n % d == 0:
            best = (n // d, d)
            break
        d -= 1
    return best


# held for the whole body of _full_float32: the TF32 flag is process-wide,
# so two threads flipping it must not interleave (reentrant: fft2d nests)
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def _full_float32(x: torch.Tensor):
    """Matrix products in true float32 on the card (TF32 off), the JAX
    backends' HIGHEST precision; the flag is restored on exit. The flag
    is process-wide, so the flip, the products and the restore run under
    one lock: a thread that leaves cannot switch TF32 back on while
    another is still inside. CPU tensors take no lock."""
    if x.device.type != "cuda":
        yield
        return
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# backends


def _fft_radix2(re, im, inverse):
    n = re.shape[-1]
    if n <= 1:
        return re, im
    lead = tuple(re.shape[:-1])
    re = bit_reverse_last_axis(re)
    im = bit_reverse_last_axis(im)
    length = 2
    while length <= n:
        half = length // 2
        wr, wi = _on(re.device, _stage_twiddle_np, length, bool(inverse))
        br = re.reshape(lead + (n // length, length))
        bi = im.reshape(lead + (n // length, length))
        ur, ui = br[..., :half], bi[..., :half]
        vr, vi = br[..., half:], bi[..., half:]
        # v * w, complex: (vr + i vi)(wr + i wi)
        tr = vr * wr - vi * wi
        ti = vr * wi + vi * wr
        re = torch.cat([ur + tr, ur - tr], -1).reshape(lead + (n,))
        im = torch.cat([ui + ti, ui - ti], -1).reshape(lead + (n,))
        length <<= 1
    return re, im


def _cmatmul_last(re, im, fr, fi):
    """(re + i im) @ (fr + i fi)^T over the last axis: out[.., k] =
    sum_t x[.., t] * F[k, t]; four real float32 products."""
    with _full_float32(re):
        rr = torch.matmul(re, fr.T)
        ii = torch.matmul(im, fi.T)
        ri = torch.matmul(re, fi.T)
        ir = torch.matmul(im, fr.T)
    return rr - ii, ri + ir


def _fft_naive(re, im, inverse):
    n = re.shape[-1]
    if n <= 1:
        return re, im
    fr, fi = _on(re.device, _dft_matrix_np, n, bool(inverse))
    return _cmatmul_last(re, im, fr, fi)


def _fft_matmul(re, im, inverse):
    """Four-step FFT over the last axis (any composite n):
    x[j1*n2 + j2] -> X[k1 + n1*k2]:
      A = F_{n1} applied over j1, B = A * T[k1, j2], C = F_{n2} applied
      over j2, X = transpose(C) flattened.
    A prime n (no split) takes the dense DFT matmul."""
    n = re.shape[-1]
    if n <= 4:
        return _fft_naive(re, im, inverse)
    n1, n2 = _split_factors(n)
    if n2 == 1:  # prime length: no four-step split exists
        return _fft_naive(re, im, inverse)
    lead = tuple(re.shape[:-1])
    ar = re.reshape(lead + (n1, n2))
    ai = im.reshape(lead + (n1, n2))
    dev, inv = re.device, bool(inverse)
    f1r, f1i = _on(dev, _dft_matrix_np, n1, inv)
    f2r, f2i = _on(dev, _dft_matrix_np, n2, inv)
    tr, ti = _on(dev, _four_step_twiddle_np, n1, n2, inv)
    # F_{n1} over the j1 axis: (k, j) @ (..., j, t)
    with _full_float32(re):
        rr = torch.matmul(f1r, ar)
        ii = torch.matmul(f1i, ai)
        ri = torch.matmul(f1i, ar)
        ir = torch.matmul(f1r, ai)
    ar, ai = rr - ii, ri + ir
    ar, ai = ar * tr - ai * ti, ar * ti + ai * tr
    ar, ai = _cmatmul_last(ar, ai, f2r, f2i)
    return (ar.transpose(-1, -2).reshape(lead + (n,)),
            ai.transpose(-1, -2).reshape(lead + (n,)))


def _fft_xla(re, im, inverse):
    x = torch.complex(re, im)
    if inverse:
        y = torch.fft.ifft(x, dim=-1) * re.shape[-1]  # undo the 1/n: unscaled
    else:
        y = torch.fft.fft(x, dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def _fft_pallas(re, im, inverse, ops=None):
    n = re.shape[-1]
    shape = re.shape
    rows = fft_rows if ops is None else ops.fft_rows
    out = rows(re.reshape(1, -1, n), im.reshape(1, -1, n), inverse=inverse, ordering="natural")
    return out[0].reshape(shape), out[1].reshape(shape)


_BACKEND_FNS = {
    "radix2": _fft_radix2,
    "matmul": _fft_matmul,
    "naive": _fft_naive,
    "xla": _fft_xla,
    "pallas": _fft_pallas,
}


def check_backend(backend: str) -> str:
    if backend not in _BACKEND_FNS:
        raise ValueError(f"unknown fft backend {backend!r}; one of {FFT_BACKENDS}")
    return backend


def fft1d(re, im, inverse: bool = False, backend: str = "radix2", ops=None):
    """1D DFT over the last axis of float32 (re, im) tensors, unscaled
    inverse, natural order. ops: where 'pallas' takes its row FFT from
    (an object with `fft_rows`, e.g. models.pipeline.PLAIN_OPS for the
    plain run on the card); None is the kernel wrapper.

    Non-power-of-two lengths: 'matmul' runs its four-step on any
    composite n (the naive DFT matmul only for primes); 'radix2' and
    'pallas' fall back to the naive DFT matmul, as the JAX fft1d does (the
    kernels' mixed-radix smooth lengths are the pipeline's fast path, not
    part of this natural-order API)."""
    re = torch.as_tensor(re, dtype=torch.float32)
    im = torch.as_tensor(im, dtype=torch.float32, device=re.device)
    if re.shape != im.shape:
        raise ValueError(f"re/im shape mismatch: {tuple(re.shape)} vs {tuple(im.shape)}")
    check_backend(backend)
    if re.ndim == 0:
        raise ValueError("fft1d needs at least one axis")
    n = re.shape[-1]
    if backend in ("radix2", "pallas") and not _is_pow2(n):
        return _fft_naive(re, im, inverse)
    if backend == "pallas":
        return (re, im) if n < 2 else _fft_pallas(re, im, inverse, ops)
    return _BACKEND_FNS[backend](re, im, inverse)


def fft2d(re, im, inverse: bool = False, backend: str = "radix2", ops=None):
    """2D separable DFT over the last two axes, unscaled inverse: row pass,
    transpose, row pass, transpose back (the JAX fft2d). ops as in fft1d."""
    re, im = fft1d(re, im, inverse, backend, ops)
    re, im = fft1d(re.transpose(-1, -2), im.transpose(-1, -2), inverse, backend, ops)
    return re.transpose(-1, -2), im.transpose(-1, -2)
