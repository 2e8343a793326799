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
The kernel is csrc/fft_radix4.cu: its stages run in register groups of
two radix-4 stages after the plan `r4_plan` computes here.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda
from fft_restoration_tpu_torch.ops.kernels.fft_kernel import (
    T_SLOTS,
    _dif_stage,
    _half_masks_np,
    _twiddle_planes_np,
    check_kernel_length,
    t_pad,
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


def _check_n(n: int) -> None:
    if n & (n - 1) or n == 0:
        raise ValueError(f"power-of-two length required, got {n}")
    if n < 4:
        raise ValueError("radix-4 kernel needs n >= 4")


def _check(re, im):
    n = re.shape[-1] if re.ndim else 0
    _check_n(n)
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


# ---------------------------------------------------------------------------
# The kernel's plan (csrc/fft_radix4.cu): the stages in register groups of
# two radix-4 stages (16 values a thread), the radix-2 tail folded into the
# last group. The kernel mirrors the index math below; the CPU tests run
# it group by group against the plain version.

R4_THREADS = 256         # the kernel's __launch_bounds__(256, 2): 128 registers a thread
R4_PLAN_THREADS = 128    # threads a block by default (tools/rows_geometry.py)
R4_SMEM_BUDGET = 32 << 10  # rows a block: those of 32 KB (2 at n = 2048), as B6's


def r4_stage_groups(n: int) -> tuple:
    """The DIF stages of radix4_stage_lengths(n) cut into register groups,
    long to short: ((log2 L, log2 E), ...), a group's items being E
    elements of a block of L. Two radix-4 stages a group (E = 16); an odd
    last radix-4 stage alone (E = 4) or with the radix-2 tail (E = 8), a
    lone tail E = 2. n = 2048: ((11, 4), (7, 4), (3, 3))."""
    lengths = radix4_stage_lengths(n)
    r4 = sum(r == 4 for _, r in lengths)
    tail = len(lengths) - r4
    groups, ll = [], n.bit_length() - 1
    for _ in range(r4 // 2):
        groups.append((ll, 4))
        ll -= 4
    if r4 % 2:
        groups.append((ll, 2 + tail))
    elif tail:
        groups.append((ll, 1))
    return tuple(groups)


class R4Plan(NamedTuple):
    """One fft_radix4 launch's geometry: rows = 2^lr rows of n points a
    block, padded row stride rs (floats), `threads` threads looping over
    the slot sets, per group (log2 L, log2 E, rot). Item (row, blk, j), j
    < d = L / E, of a group holds the E elements blk * L + e * d + j, e <
    E; its index's fields are j, blk, row, j fastest (neighbouring threads
    on neighbouring elements), the blk field rotated left one bit when
    rot is 1 (a warp's blocks two apart). Slot s of slot set u holds
    element s mod E of item u + (s // E) * slot_sets."""

    n: int
    log2n: int
    lr: int
    rs: int
    threads: int
    groups: tuple

    @property
    def rows(self) -> int:
        return 1 << self.lr

    @property
    def slot_sets(self) -> int:
        return self.rows * self.n // T_SLOTS

    @property
    def smem_bytes(self) -> int:
        """A one-group launch exchanges nothing: no shared memory."""
        return 8 * self.rows * self.rs if len(self.groups) > 1 else 0

    def c_plan(self) -> np.ndarray:
        """The int32 plan array of the C entry: groups, then per group
        log2 L, log2 E and rot."""
        return np.array([len(self.groups)] + [v for g in self.groups for v in g], np.int32)


def r4_slot_index(plan: R4Plan, group: tuple) -> tuple:
    """(row, column) in the block of every (slot set, slot) of a group
    (log2 L, log2 E, rot): two (slot_sets, 16) int arrays."""
    ll, le, rot = group
    ld, lb = ll - le, plan.log2n - ll
    u = np.arange(plan.slot_sets, dtype=np.int64)[:, None]
    s = np.arange(T_SLOTS, dtype=np.int64)[None, :]
    it = u + (s >> le) * plan.slot_sets
    j, f, row = it & ((1 << ld) - 1), (it >> ld) & ((1 << lb) - 1), it >> (ld + lb)
    blk = (((f << 1) | (f >> (lb - 1))) & ((1 << lb) - 1)) if rot and lb > 0 else f
    col = (blk << ll) | ((s & ((1 << le) - 1)) << ld) | j
    return row, col


def r4_bank_conflicts(plan: R4Plan, group: tuple) -> int:
    """The most threads of one warp that hit one bank with one shared
    access of a group (1: conflict-free) in the padded rows (t_pad)."""
    row, col = r4_slot_index(plan, group)
    addr = row * plan.rs + t_pad(col)
    warp = np.arange(addr.shape[0])[:, None] // 32
    key = (warp * T_SLOTS + np.arange(T_SLOTS)[None, :]) * 32 + addr % 32
    return int(np.bincount(key.ravel()).max())


@functools.lru_cache(maxsize=None)
def r4_plan(n: int, m: int = 1 << 30, rows: int = 0, threads: int = 0) -> R4Plan:
    """The fft_radix4 plan of m rows of n points.

    Rows a block: the largest power of two up to 16 and m whose rows fit
    R4_SMEM_BUDGET, at least 16 / n (a thread's 16 slots); threads:
    R4_PLAN_THREADS, fewer for a block of fewer slot sets. `rows` and
    `threads` override the two (tools/rows_geometry.py). The top group
    loads device memory and the bottom group (d = 1: an item is E
    consecutive elements) stores them as vectors, both unrotated; a
    middle group rotates its blk field where r4_bank_conflicts finds that
    cheaper. The row stride is the first past the padded row that keeps
    the groups' accesses cheapest."""
    _check_n(n)
    check_kernel_length(n)
    if not rows:
        fit = max(1, min(16, R4_SMEM_BUDGET // (8 * n), m))
        rows = max(1 << (fit.bit_length() - 1), T_SLOTS // n)
    if rows & (rows - 1) or rows * n < T_SLOTS:
        raise ValueError(f"rows a block must be a power of two >= {max(1, T_SLOTS // n)}, "
                         f"got {rows}")
    lr = rows.bit_length() - 1
    ns = rows * n // T_SLOTS
    threads = threads or min(R4_PLAN_THREADS, -(-ns // 32) * 32)
    if threads % 32 or not 32 <= threads <= R4_THREADS:
        raise ValueError(f"threads a block must be a multiple of 32 up to {R4_THREADS}")
    spec = r4_stage_groups(n)
    best = None
    for extra in range(32):
        plan = R4Plan(n, n.bit_length() - 1, lr, t_pad(n) + extra, threads, ())
        groups, costs = [], []
        for g, (ll, le) in enumerate(spec):
            pinned = g in (0, len(spec) - 1)
            choice = [(ll, le, 0)] if pinned else [(ll, le, 0), (ll, le, 1)]
            cost = [r4_bank_conflicts(plan, c) for c in choice]
            groups.append(choice[int(np.argmin(cost))])
            costs.append(min(cost))
        key = (max(costs), sum(costs))
        if best is None or key < best[0]:
            best = key, plan._replace(groups=tuple(groups))
        if key == (1, len(spec)):
            break
    return best[1]


def fft_rows_radix4_fwd(re, im=None):
    """Forward DIF over the last axis of (..., N) float32 rows, N a power of
    two >= 4: radix-4 stages, then a radix-2 tail (B12, the JAX
    fft_rows_radix4_fwd). im=None is a real input (zeros made in the
    kernel). Natural input, digit-reversed output in the JAX kernel's
    order (`radix4_output_permutation`), unscaled. Operands contiguous.
    Returns (re, im) shaped as the input. The kernel (csrc/fft_radix4.cu)
    runs r4_plan's register groups."""
    if not on_cuda(*(t for t in (re, im) if t is not None)):
        return fft_rows_radix4_fwd_plain(re, im)
    n = _check(re, im)
    check_kernel_length(n)
    if not re.is_contiguous() or (im is not None and not im.is_contiguous()):
        raise ValueError("rows must be contiguous")
    rows_total = re.numel() // n
    return launch_radix4(re, im, r4_plan(n, rows_total))


@functools.lru_cache(maxsize=256)
def _r4_launch_args(plan: R4Plan, device) -> tuple:
    """The table and plan pointers of one fft_radix4 launch, worked out once
    per plan. The plan array stays alive in the cache."""
    c4, s4 = _r4_tables(plan.n, device)
    t2 = tables(plan.n, False, device)
    c_plan = plan.c_plan()
    return (c4.data_ptr(), s4.data_ptr(), t2.cos.data_ptr(), t2.sin.data_ptr(),
            c_plan.ctypes.data), c_plan


def launch_radix4(re, im, plan: R4Plan):
    """One fft_radix4 launch of contiguous (..., N) rows with `plan`
    (r4_plan; tools/rows_geometry.py passes its overrides)."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    n = plan.n
    out_re, out_im = torch.empty_like(re), torch.empty_like(re)
    ptrs, _ = _r4_launch_args(plan, re.device)
    err = _build.load().fft_radix4_launch(
        re.data_ptr(), None if im is None else im.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), re.numel() // n, plan.log2n, plan.lr, plan.rs, plan.threads, *ptrs,
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "fft_rows_radix4")
    launch_counts["fft_rows_radix4"] += 1
    return out_re, out_im
