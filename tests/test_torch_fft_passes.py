"""B1's stage plan (csrc/fft_rows_t.cu) emulated group by group on the CPU.

The kernel runs the radix-2 stages of a row in groups held in registers
and the cross levels in one pass, after the plan that
`fft_kernel.t_plan` computes (stage groups, 16 slots a thread, the
thread-to-element map, the padded shared rows). Only the card runs that
index math, so these tests run it here in plain torch: the emulation
below gathers each group's slots from a block's padded shared-memory
image at the plan's addresses, runs the group's butterflies slot pair by
slot pair with the stage tables, and scatters them back, as the kernel
does; the cross levels run per item (row, b) on the R elements
b + j * q. It must be BITWISE equal to the plain version's run_stages
(the same float32 operations in the same order), forward and inverse,
at every pow2 n from 2 to 16384 and at the smooth lengths the pads give;
and it must match the JAX package's _fft_rows_transposed (interpret mode,
engine="roll") at the tolerance of tests/test_torch_mixed_radix.py.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import fft_kernel as jfk
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

REL = 1e-5
POW2 = [1 << s for s in range(1, 15)]
SMOOTH = [(384, (3,)), (640, (5,)), (1152, (3, 3)), (1920, (3, 5)), (2304, (3, 3)),
          (3840, (3, 5))]


def _cross(xr, xi, radices, tab, b, q, inverse):
    """Both cross levels of items (.., b) holding x[.., j], j = j0 * R1 +
    j1, element b + j1*q + j0*q0 (fft_common.cuh cross_item)."""
    r0, r1 = (radices + (1,))[:2]
    q0, n = q * r1, q * r0 * r1
    xr, xi = list(xr.unbind(-1)), list(xi.unbind(-1))

    def dft(vr, vi, lvl):
        c, s = tfk._cross_coefs_np(radices[lvl], inverse)
        out_r, out_i = [], []
        for k in range(len(vr)):
            ar, ai = vr[0], vi[0]
            for j in range(1, len(vr)):
                m = (k * j) % len(vr)
                if m == 0:
                    tr, ti = vr[j], vi[j]
                else:
                    cm, sm = float(c[m]), float(s[m])
                    tr, ti = cm * vr[j] - sm * vi[j], cm * vi[j] + sm * vr[j]
                ar, ai = ar + tr, ai + ti
            out_r.append(ar)
            out_i.append(ai)
        return out_r, out_i

    def tw(vr, vi, lvl, idx):
        tc, ts = tab.xcos[lvl][idx], tab.xsin[lvl][idx]
        return vr * tc - vi * ts, vr * ts + vi * tc

    def level0(pre):
        for j1 in range(r1):
            idx = [j0 * r1 + j1 for j0 in range(r0)]
            vr, vi = [xr[i] for i in idx], [xi[i] for i in idx]
            if pre:
                for a, j0 in enumerate(range(r0)):
                    vr[a], vi[a] = tw(vr[a], vi[a], 0, b + j1 * q + j0 * q0)
            vr, vi = dft(vr, vi, 0)
            for a, k0 in enumerate(range(r0)):
                if not pre:
                    vr[a], vi[a] = tw(vr[a], vi[a], 0, b + j1 * q + k0 * q0)
                xr[idx[a]], xi[idx[a]] = vr[a], vi[a]

    def level1(pre):
        for k0 in range(r0):
            idx = [k0 * r1 + j1 for j1 in range(r1)]
            vr, vi = [xr[i] for i in idx], [xi[i] for i in idx]
            if pre:
                for a in range(r1):
                    vr[a], vi[a] = tw(vr[a], vi[a], 1, b + a * q + k0 * q0)
            vr, vi = dft(vr, vi, 1)
            for a in range(r1):
                if not pre:
                    vr[a], vi[a] = tw(vr[a], vi[a], 1, b + a * q + k0 * q0)
                xr[idx[a]], xi[idx[a]] = vr[a], vi[a]

    assert n == tab.xcos.shape[-1]
    if not inverse:
        level0(False)
        if r1 > 1:
            level1(False)
    else:
        if r1 > 1:
            level1(True)
        level0(True)
    return torch.stack(xr, -1), torch.stack(xi, -1)


def _group(sre, sim, src, plan, group, tab, dit, dst=None):
    """One stage group over every block: gather the slots (from src =
    (re, im) blocks of rows, the forward pow2 pass's device-memory load,
    else from the shared image), the group's butterflies, scatter (to dst
    = (re, im) blocks of rows, the forward pass's direct store, else to
    the shared image)."""
    s_lo, k, _, _ = group
    row, col = tfk.t_slot_index(plan, group)
    addr = torch.from_numpy(row * plan.rs + tfk.t_pad(col))
    if src is not None:
        xr, xi = (x[:, torch.from_numpy(row), torch.from_numpy(col)] for x in src)
    else:
        xr, xi = sre[:, addr], sim[:, addr]
    xr, xi = list(xr.unbind(-1)), list(xi.unbind(-1))
    lo = torch.from_numpy(col & ((1 << s_lo) - 1))
    for b in (range(k) if dit else range(k - 1, -1, -1)):
        s = s_lo + b
        for j in range(tfk.T_SLOTS):
            jl = j & ((1 << k) - 1)
            if jl & (1 << b):
                continue
            j2 = j + (1 << b)
            pos = lo[:, j] + ((jl & ((1 << b) - 1)) << s_lo)
            c, sn = tab.cos[s][pos], tab.sin[s][pos]
            ar, ai, br, bi = xr[j], xi[j], xr[j2], xi[j2]
            if dit:
                wr, wi = c * br - sn * bi, c * bi + sn * br
                xr[j], xi[j], xr[j2], xi[j2] = ar + wr, ai + wi, ar - wr, ai - wi
            else:
                dr, di = ar - br, ai - bi
                xr[j], xi[j] = ar + br, ai + bi
                xr[j2], xi[j2] = c * dr - sn * di, c * di + sn * dr
    if dst is not None:
        for o, v in zip(dst, (xr, xi)):
            o[:, torch.from_numpy(row), torch.from_numpy(col)] = torch.stack(v, -1)
    else:
        sre[:, addr] = torch.stack(xr, -1)
        sim[:, addr] = torch.stack(xi, -1)


def emulate_rows_t(x_re, x_im, inverse, radices=()):
    """fft_rows_t's plan on (M, n) float32 rows: (n, M) transposed output."""
    m, n = x_re.shape
    plan = tfk.t_plan(n, radices, m, inverse)
    tab = tfk.tables(n, inverse, torch.device("cpu"), radices)
    rows, q = plan.rows, 1 << plan.logq
    nblk = -(-m // rows)
    blocks = [torch.zeros(nblk * rows, n).index_copy(0, torch.arange(m), x)
              .reshape(nblk, rows, n) for x in (x_re, x_im)]
    # the shared image, NaN where no slot was written
    sre, sim = (torch.full((nblk, rows * plan.rs), float("nan")) for _ in range(2))
    cols = tfk.t_cross_columns(plan, radices)
    rr = np.arange(rows)[:, None, None]
    if not inverse:
        src = blocks
        if radices:  # load + both cross levels, item (row, b)
            xr, xi = (x[:, torch.from_numpy(rr), torch.from_numpy(cols)] for x in blocks)
            xr, xi = _cross(xr, xi, radices, tab, torch.arange(q), q, False)
            addr = torch.from_numpy((rr * plan.rs + tfk.t_pad(cols[None])).reshape(rows, -1))
            sre[:, addr], sim[:, addr] = xr.reshape(nblk, rows, -1), xi.reshape(nblk, rows, -1)
            src = None
        out = [torch.full((nblk, rows, n), float("nan")) for _ in range(2)]
        last = len(plan.groups) - 1
        for g, group in enumerate(plan.groups):
            _group(sre, sim, src if g == 0 else None, plan, group, tab, False,
                   out if plan.direct_store and g == last else None)
        if plan.direct_store:
            return tuple(o.reshape(-1, n)[:m].T.contiguous() for o in out)
    else:
        addr = torch.from_numpy(np.arange(rows)[:, None] * plan.rs + tfk.t_pad(np.arange(n)))
        sre[:, addr], sim[:, addr] = blocks
        for group in reversed(plan.groups):
            _group(sre, sim, None, plan, group, tab, True)
        if radices:
            addr = torch.from_numpy(rr * plan.rs + tfk.t_pad(cols[None]))
            xr, xi = _cross(sre[:, addr], sim[:, addr], radices, tab, torch.arange(q), q, True)
            out = [torch.empty(nblk, rows, n) for _ in range(2)]
            idx = torch.from_numpy(cols.reshape(-1))
            for o, v in zip(out, (xr, xi)):
                o[:, :, idx] = v.reshape(nblk, rows, -1)
            return tuple(o.reshape(-1, n)[:m].T.contiguous() for o in out)
    addr = torch.from_numpy(np.arange(rows)[:, None] * plan.rs + tfk.t_pad(np.arange(n)))
    return tuple(s[:, addr].reshape(-1, n)[:m].T.contiguous() for s in (sre, sim))


def _planes(m, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32))
                 for _ in range(2))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,radices", [(n, ()) for n in POW2] + SMOOTH)
def test_plan_emulation_bitwise_equals_run_stages(n, radices, inverse):
    m = 3 if n >= 8192 else 9 if n >= 1024 else 20  # a ragged last row block
    x_re, x_im = _planes(m, n, n + inverse)
    ours = emulate_rows_t(x_re, x_im, inverse, radices)
    ref = tfk.run_stages(x_re, x_im, inverse, radices)
    for o, r in zip(ours, ref):
        assert torch.equal(o, r.T), float((o - r.T).abs().max())


@pytest.mark.parametrize("n,radices", [(n, ()) for n in POW2] + SMOOTH)
def test_plan_maps_every_element_once_without_bank_conflicts(n, radices):
    """Each group's slots cover the block's rows x n elements once, inside
    the padded rows; the exchanges of the main shapes hit distinct banks
    (at most 2 threads a bank elsewhere, 4 in one group of n = 16384's one
    row)."""
    for inverse in (False, True):
        plan = tfk.t_plan(n, radices, 1 << 20, inverse)
        assert sum(k for _, k, _, _ in plan.groups) == plan.logq
        assert plan.smem_bytes <= tfk.T_SMEM_BUDGET or plan.rows == max(1, 16 >> plan.logq)
        for group in plan.groups:
            row, col = tfk.t_slot_index(plan, group)
            flat = np.sort((row * n + col).ravel())
            assert np.array_equal(flat, np.arange(plan.rows * n))
            assert (tfk.t_pad(col) < plan.rs).all()
            worst = tfk.t_bank_conflicts(plan, group)
            limit = 1 if n in (384, 512) else 4 if n == 16384 else 2
            assert worst <= limit, (group, worst)
        # the shared-memory transposed read, neighbouring threads on
        # neighbouring rows (the direct store reads no shared memory)
        assert plan.direct_store == (not inverse and plan.rows >= 4 and len(plan.groups) > 1)
        if not plan.direct_store:
            t = np.arange(min(32, plan.rows * n))
            addr = (t & (plan.rows - 1)) * plan.rs + tfk.t_pad(t >> plan.lr)
            assert len(np.unique(addr % 32)) == len(t)


def test_plan_rows_and_store_segments():
    """8 rows a block (32-byte column segments of the transposed store) at
    n = 2048 and 2304, 4 at 3840 and 4096; 3 groups at n = 2048."""
    assert tfk.t_plan(2048).rows == 8 and tfk.t_plan(2304, (3, 3)).rows == 8
    assert tfk.t_plan(3840, (3, 5)).rows == 4 and tfk.t_plan(4096).rows == 4
    assert tfk.t_stage_groups(11) == ((7, 4), (3, 4), (0, 3))
    assert [k for _, k in tfk.t_stage_groups(14)] == [4, 4, 3, 3]
    assert tfk.t_plan(2048).threads == 512 and tfk.t_plan(8, (), 4).threads == 32
    # a launch of few pairs takes smaller blocks, down to 8 rows, to fill
    # the card (blocks_wanted a pair)
    assert tfk.t_plan(256, (), 256, True, 3).rows == 64
    assert tfk.t_plan(256, (), 256, True, 6).rows == 32
    assert tfk.t_plan(640, (5,), 384, False, 44).rows == 8
    assert tfk.t_plan(3840, (3, 5), 2304, False, 132).rows == 4


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,radices", [(256, ()), (2048, ()), (3840, (3, 5))])
def test_plan_emulation_matches_jax_transposed(n, radices, inverse):
    x_re, x_im = _planes(8, n, 7 * n + inverse)
    ref = jfk.fft_rows_pallas(jnp.asarray(x_re.numpy()[None]), jnp.asarray(x_im.numpy()[None]),
                              inverse, ordering="revorder", transposed_output=True,
                              engine="roll", radices=radices)
    ours = emulate_rows_t(x_re, x_im, inverse, radices)
    for o, r in zip(ours, ref):
        r = np.asarray(r)[0]
        assert o.shape == r.shape
        assert np.abs(o.numpy() - r).max() <= REL * max(float(np.abs(r).max()), 1e-30)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the exact rational x."""
    c = np.float32(float(x))
    near = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(near, key=lambda v: abs(Fraction(float(v)) - x))


def test_u8_load_is_the_true_division():
    """The kernels' uint8 load (csrc/fft_rows_load.cuh to_f32): q = v * r,
    r = float32(1 / 255), then q + fma(-255, q, v) * r, each step rounded
    once, gives float32(v) / float32(255) bit for bit for every value."""
    r = np.float32(1.0) / np.float32(255.0)
    for v in range(256):
        a = np.float32(v)
        q = np.float32(a * r)
        e = _round_f32(Fraction(float(a)) - 255 * Fraction(float(q)))
        q2 = _round_f32(Fraction(float(e)) * Fraction(float(r)) + Fraction(float(q)))
        assert q2 == a / np.float32(255.0), v
