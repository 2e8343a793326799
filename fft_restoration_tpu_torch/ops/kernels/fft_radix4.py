"""Radix-4 forward row FFT (B12) — wrapper, plain version, host helpers.

Counterpart of fft_restoration_tpu/ops/pallas/fft_radix4.py, the JAX
package's experiment on whether radix-4 stages beat radix-2 ones (its
tools/perf_ab.py radix4; here fft_restoration_tpu_torch/tools/perf_ab.py).
Forward DIF only: natural input, mixed-radix digit-reversed output
(stage lengths long to short, [4] * a + [2] * b for n = 4^a * 2^b). An
elementwise filter round trip could consume any fixed permutation, so
the order is no blocker; `radix4_output_permutation` gives it.

The host helpers are numpy copies of the JAX module's (the port imports
nothing of it): `radix4_stage_lengths`, `_r4_tables_np`, `_numpy_sim`
(the kernel's stage math in float64) and `radix4_output_permutation`.
The radix-2 tail reads the forward tables of ops/kernels/fft_kernel.py,
the JAX module's `_twiddle_planes_np(n, False)` and `_half_masks_np(n)`.
The kernel is csrc/fft_radix4.cu.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda
from fft_restoration_tpu_torch.ops.kernels.fft_kernel import (
    _dif_stage,
    _half_masks_np,
    _twiddle_planes_np,
    check_kernel_length,
    rows_per_block,
    tables,
)


def radix4_stage_lengths(n: int) -> list:
    """DIF stage lengths long->short: radix-4 while L % 4 == 0, else 2."""
    out = []
    length = n
    while length >= 4 and length % 4 == 0:
        out.append((length, 4))
        length //= 4
    while length >= 2:
        out.append((length, 2))
        length //= 2
    return out


@functools.lru_cache(maxsize=None)
def _r4_tables_np(n: int) -> tuple:
    """Per radix-4 stage: lane tables (cos, sin) of W_L^{j*k} (j = lane
    offset within quarter, k = quarter index) and the quarter index."""
    stages = [L for L, r in radix4_stage_lengths(n) if r == 4]
    cos = np.empty((len(stages), n), np.float32)
    sin = np.empty((len(stages), n), np.float32)
    quarter = np.empty((len(stages), n), np.float32)
    t = np.arange(n, dtype=np.int64)
    for s, L in enumerate(stages):
        q = L // 4
        k = (t % L) // q
        j = (t % L) % q
        ang = -2.0 * math.pi * (j * k) / L
        cos[s] = np.cos(ang).astype(np.float32)
        sin[s] = np.sin(ang).astype(np.float32)
        quarter[s] = k.astype(np.float32)
    return cos, sin, quarter


def _numpy_sim(re: np.ndarray, im: np.ndarray | None) -> tuple:
    """Reference NumPy implementation of the kernel's exact stage math
    (float64, the JAX module's formulation with rolls and quarter picks)."""
    n = re.shape[-1]
    x_re = re.astype(np.float64)
    x_im = np.zeros_like(x_re) if im is None else im.astype(np.float64)

    def roll(v, amt):
        return np.roll(v, amt, axis=-1)

    c4, s4, kq4 = _r4_tables_np(n)
    for s in range(c4.shape[0]):
        L = n >> (2 * s)
        q = L // 4
        wc, ws, kq = c4[s].astype(np.float64), s4[s].astype(np.float64), kq4[s]
        rp = [(roll(x_re, n - m * q), roll(x_im, n - m * q)) for m in (1, 2, 3)]
        rm = [(roll(x_re, m * q), roll(x_im, m * q)) for m in (1, 2, 3)]

        def pick(v0, v1, v2, v3):
            return np.where(
                kq == 1, v1, np.where(kq == 2, v2, np.where(kq == 3, v3, v0))
            )

        a_re = pick(x_re, rm[0][0], rm[1][0], rm[2][0])
        a_im = pick(x_im, rm[0][1], rm[1][1], rm[2][1])
        b_re = pick(rp[0][0], x_re, rm[0][0], rm[1][0])
        b_im = pick(rp[0][1], x_im, rm[0][1], rm[1][1])
        c_re = pick(rp[1][0], rp[0][0], x_re, rm[0][0])
        c_im = pick(rp[1][1], rp[0][1], x_im, rm[0][1])
        d_re = pick(rp[2][0], rp[1][0], rp[0][0], x_re)
        d_im = pick(rp[2][1], rp[1][1], rp[0][1], x_im)
        t1_re, t1_im = a_re + c_re, a_im + c_im
        t2_re, t2_im = a_re - c_re, a_im - c_im
        t3_re, t3_im = b_re + d_re, b_im + d_im
        t4_re, t4_im = b_re - d_re, b_im - d_im
        y_re = pick(t1_re + t3_re, t2_re + t4_im, t1_re - t3_re, t2_re - t4_im)
        y_im = pick(t1_im + t3_im, t2_im - t4_re, t1_im - t3_im, t2_im + t4_re)
        x_re = y_re * wc - y_im * ws
        x_im = y_re * ws + y_im * wc

    cos2, sin2 = _twiddle_planes_np(n, False)
    mask2 = _half_masks_np(n)
    for L in [LL for LL, r in radix4_stage_lengths(n) if r == 2]:
        half = L // 2
        s2 = half.bit_length() - 1
        wc = cos2[s2].astype(np.float64)
        ws = sin2[s2].astype(np.float64)
        m = mask2[s2]
        p_re, p_im = roll(x_re, n - half), roll(x_im, n - half)
        q_re, q_im = roll(x_re, half), roll(x_im, half)
        d_re, d_im = q_re - x_re, q_im - x_im
        wd_re = wc * d_re - ws * d_im
        wd_im = wc * d_im + ws * d_re
        x_re = np.where(m > 0.5, x_re + p_re, wd_re)
        x_im = np.where(m > 0.5, x_im + p_im, wd_im)
    return x_re, x_im


def radix4_output_permutation(n: int) -> np.ndarray:
    """perm such that fft_rows_radix4_fwd(x)[..., t] == FFT(x)[..., perm[t]]:
    the kernel math simulated in numpy on an impulse at 1, whose DFT
    e^{-2 pi i k / n} is unique per k."""
    x = np.zeros(n, np.float32)
    x[1] = 1.0
    re, im = _numpy_sim(x[None, :], None)
    ang = np.angle(re[0] + 1j * im[0])
    return np.round((-ang) * n / (2 * np.pi)).astype(np.int64) % n


def _check(re, im):
    n = re.shape[-1] if re.ndim else 0
    if n & (n - 1) or n == 0:
        raise ValueError(f"power-of-two length required, got {n}")
    if n < 4:
        raise ValueError("radix-4 kernel needs n >= 4")
    if re.dtype != torch.float32 or (im is not None and (im.dtype != torch.float32
                                                         or im.shape != re.shape)):
        raise ValueError("need float32 re (and im of re's shape)")
    return n


def _stage_counts(n: int) -> tuple:
    lengths = radix4_stage_lengths(n)
    return sum(r == 4 for _, r in lengths), sum(r == 2 for _, r in lengths)


def fft_rows_radix4_fwd_plain(re, im=None):
    """Plain version of `fft_rows_radix4_fwd`: each radix-4 stage on
    (rows, n / L, 4, q) views, the kernel's arithmetic and tables, then
    the radix-2 tail through fft_kernel's DIF stage."""
    n = _check(re, im)
    x_re = re.reshape(-1, n)
    x_im = torch.zeros_like(x_re) if im is None else im.reshape(-1, n)
    c4, s4, _ = (torch.from_numpy(a).to(re.device) for a in _r4_tables_np(n))
    n4, tail = _stage_counts(n)
    for s in range(n4):
        L = n >> (2 * s)
        q = L // 4
        v_re = x_re.reshape(-1, n // L, 4, q)
        v_im = x_im.reshape(-1, n // L, 4, q)
        a_re, b_re, c_re, d_re = v_re.unbind(2)
        a_im, b_im, c_im, d_im = v_im.unbind(2)
        t1_re, t1_im = a_re + c_re, a_im + c_im
        t2_re, t2_im = a_re - c_re, a_im - c_im
        t3_re, t3_im = b_re + d_re, b_im + d_im
        t4_re, t4_im = b_re - d_re, b_im - d_im
        y_re = torch.stack([t1_re + t3_re, t2_re + t4_im, t1_re - t3_re, t2_re - t4_im], 2)
        y_im = torch.stack([t1_im + t3_im, t2_im - t4_re, t1_im - t3_im, t2_im + t4_re], 2)
        wc = c4[s].reshape(n // L, 4, q)
        ws = s4[s].reshape(n // L, 4, q)
        x_re = (y_re * wc - y_im * ws).reshape(-1, n)
        x_im = (y_re * ws + y_im * wc).reshape(-1, n)
    t = tables(n, False, re.device)
    for s2 in range(tail - 1, -1, -1):
        x_re, x_im = _dif_stage(x_re, x_im, t.cos[s2], t.sin[s2], t.mask[s2], 1 << s2)
    return x_re.reshape(re.shape), x_im.reshape(re.shape)


@functools.lru_cache(maxsize=None)
def _r4_tables(n: int, device: torch.device) -> tuple:
    """The radix-4 cos/sin tables on `device`, uploaded once per (n, device)."""
    c4, s4, _ = _r4_tables_np(n)
    return torch.from_numpy(c4).to(device), torch.from_numpy(s4).to(device)


def fft_rows_radix4_fwd(re, im=None):
    """Forward DIF over the last axis of (..., N) float32 rows, N a power of
    two >= 4: radix-4 stages, then a radix-2 tail (B12, the JAX
    fft_rows_radix4_fwd). im=None is a real input (zeros made in the
    kernel). Natural input, digit-reversed output in the JAX kernel's
    order (`radix4_output_permutation`), unscaled. Operands contiguous.
    Returns (re, im) shaped as the input."""
    if not on_cuda(*(t for t in (re, im) if t is not None)):
        return fft_rows_radix4_fwd_plain(re, im)
    from fft_restoration_tpu_torch.ops.kernels import _build

    n = _check(re, im)
    check_kernel_length(n)
    if not re.is_contiguous() or (im is not None and not im.is_contiguous()):
        raise ValueError("rows must be contiguous")
    rows_total = re.numel() // n
    n4, tail = _stage_counts(n)
    c4, s4 = _r4_tables(n, re.device)
    t2 = tables(n, False, re.device)
    out_re, out_im = torch.empty_like(re), torch.empty_like(re)
    err = _build.load().fft_radix4_launch(
        re.data_ptr(), None if im is None else im.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), rows_total, n, n.bit_length() - 1, n4, tail,
        rows_per_block(n, rows_total), c4.data_ptr(), s4.data_ptr(), t2.cos.data_ptr(),
        t2.sin.data_ptr(), torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "fft_rows_radix4")
    launch_counts["fft_rows_radix4"] += 1
    return out_re, out_im
