"""The row kernels' stage plans emulated group by group on the CPU.

B1 (csrc/fft_rows_t.cu, `fft_kernel.t_plan`) and B3/B6 (csrc/fft_rows.cu,
`fft_kernel.r_plan`) run the radix-2 stages of a row in groups held in
registers (csrc/fft_groups.cuh) and the cross levels in one pass, after
a plan: stage groups, 16 slots a thread, the thread-to-element map, the
padded shared rows. Only the card runs that index math, so these tests
run it here in plain torch: the emulation below gathers each group's
slots from a block's rows (a device load: B1's and B6's forward row
load, B3/B6's inverse vector load, the natural ordering's bit-reversed
load) or from its padded shared-memory image at the plan's addresses,
runs the group's butterflies slot pair by slot pair with the stage
tables, and scatters them to the output (B1's transposed store, B3/B6's
row and vector stores) or back to the image, as the kernels do; the
cross levels run per item (row, b) on the R elements b + j * q. Each
emulation must be BITWISE equal to the plain version's run_stages (the
same float32 operations in the same order), forward and inverse, at
every pow2 n from 2 to 16384 and at the smooth lengths the pads give,
B3's min/max partials too; and it must match the JAX package's kernels
(interpret mode, engine="roll": _fft_rows_transposed, fft_rows_pallas in
both orderings, fft_rows_packed_out) at the tolerance of
tests/test_torch_mixed_radix.py. The plans' bank conflicts and their
device accesses (whole 32-byte segments a warp) are checked here too.
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


def _group(sre, sim, src, plan, group, tab, dit, dst=None, brev=False):
    """One stage group over every block: gather the slots (from src =
    (re, im) blocks of rows, a device-memory load, else from the shared
    image), the group's butterflies, scatter (to dst = (re, im) blocks of
    rows, a direct store, else to the shared image). brev: the natural
    ordering's first DIT group, whose slot at column b loads device
    column bit_reverse(b)."""
    s_lo, k, _, _ = group
    row, col = tfk.t_slot_index(plan, group, brev)
    addr = torch.from_numpy(row * plan.rs + tfk.t_pad(col))
    if src is not None:
        dev = tfk.brev_columns(col, plan.logq) if brev else col
        xr, xi = (x[:, torch.from_numpy(row), torch.from_numpy(dev)] for x in src)
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


def emulate_rows(x_re, x_im, inverse, radices=(), natural=False, packed=False):
    """fft_rows' plan (csrc/fft_rows.cu, B3/B6) on (M, n) float32 rows:
    (M, n) row-major output. Forward: the top group loads (pow2; a mixed
    pass loads through its cross levels into the shared image), the
    bottom group stores its consecutive columns; inverse: the bottom group
    loads, the top group stores (a mixed pass stores after its cross
    levels); natural: the bottom group loads the bit-reversed map;
    packed: the packed store's plan (blocks of one min/max partial)."""
    m, n = x_re.shape
    plan = tfk.r_plan(n, radices, m, inverse, natural, packed=packed)
    tab = tfk.tables(n, inverse, torch.device("cpu"), radices)
    rows, q = plan.rows, 1 << plan.logq
    nblk = -(-m // rows)
    blocks = [torch.zeros(nblk * rows, n).index_copy(0, torch.arange(m), x)
              .reshape(nblk, rows, n) for x in (x_re, x_im)]
    sre, sim = (torch.full((nblk, rows * plan.rs), float("nan")) for _ in range(2))
    out = [torch.full((nblk, rows, n), float("nan")) for _ in range(2)]
    cols = tfk.t_cross_columns(plan, radices)
    rr = np.arange(rows)[:, None, None]
    addr = torch.from_numpy((rr * plan.rs + tfk.t_pad(cols[None])).reshape(rows, -1))
    last = len(plan.groups) - 1
    if not inverse and not natural:
        src = blocks
        if radices:  # load + both cross levels, item (row, b)
            xr, xi = (x[:, torch.from_numpy(rr), torch.from_numpy(cols)] for x in blocks)
            xr, xi = _cross(xr, xi, radices, tab, torch.arange(q), q, False)
            sre[:, addr], sim[:, addr] = xr.reshape(nblk, rows, -1), xi.reshape(nblk, rows, -1)
            src = None
        for g, group in enumerate(plan.groups):
            _group(sre, sim, src if g == 0 else None, plan, group, tab, False,
                   out if g == last else None)
    else:
        for g in range(last, -1, -1):
            _group(sre, sim, blocks if g == last else None, plan, plan.groups[g], tab, True,
                   out if g == 0 and not radices else None, natural and g == last)
        if radices:
            xr, xi = _cross(sre[:, addr].reshape(nblk, rows, q, -1),
                            sim[:, addr].reshape(nblk, rows, q, -1), radices, tab,
                            torch.arange(q), q, True)
            idx = torch.from_numpy(cols.reshape(-1))
            for o, v in zip(out, (xr, xi)):
                o[:, :, idx] = v.reshape(nblk, rows, -1)
    return tuple(o.reshape(-1, n)[:m] for o in out)


def emulate_packed(x_re, x_im, inverse, radices=()):
    """fft_rows_packed_out's launch (B3): the row-major plan into one
    (2, M, n) output, and the min/max partials that each block folds from
    the values it stores, one per rows_per_block(n, M) rows."""
    m, n = x_re.shape
    o_re, o_im = emulate_rows(x_re, x_im, inverse, radices, packed=True)
    pg = tfk.rows_per_block(n, m)
    b_re, b_im = o_re.reshape(m // pg, -1), o_im.reshape(m // pg, -1)
    mm = torch.stack([b_re.amin(-1), b_re.amax(-1), b_im.amin(-1), b_im.amax(-1)], -1)
    return torch.stack([o_re, o_im]), mm


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


# B3/B6's plan (csrc/fft_rows.cu, fft_kernel.r_plan): the row-major stores

ROW_MODES = ([(n, (), mode) for n in POW2
              for mode in ("forward", "inverse", "natural_forward", "natural_inverse",
                           "packed_forward", "packed_inverse")]
             + [(n, rad, mode) for n, rad in SMOOTH
                for mode in ("forward", "inverse", "packed_forward", "packed_inverse")])


@pytest.mark.parametrize("n,radices,mode", ROW_MODES)
def test_row_plan_emulation_bitwise_equals_run_stages(n, radices, mode):
    """Every store and ordering of fft_rows' plan, group by group, is the
    plain version's run_stages bit for bit; the packed store's partials
    too (a ragged last row block for the natural store)."""
    inverse = mode.endswith("inverse")
    if mode.startswith("packed"):
        m = 3 if n >= 8192 else 2 * tfk.rows_per_block(n, 16)
        x_re, x_im = _planes(m, n, 3 * n + inverse)
        out, mm = emulate_packed(x_re, x_im, inverse, radices)
        ref_out, ref_mm = tfk.fft_rows_packed_out_plain(x_re[None], x_im[None], inverse=inverse,
                                                         radices=radices)
        assert torch.equal(out, ref_out) and torch.equal(mm, ref_mm)
        return
    natural = mode.startswith("natural")
    m = 3 if n >= 8192 else 9 if n >= 1024 else 20
    x_re, x_im = _planes(m, n, 5 * n + inverse + 2 * natural)
    ours = emulate_rows(x_re, x_im, inverse, radices, natural)
    ref = tfk.run_stages(x_re, x_im, inverse, radices, natural)
    for o, r in zip(ours, ref):
        assert torch.equal(o, r), float((o - r).abs().max())


@pytest.mark.parametrize("n,radices", [(2, ()), (4, ()), (8, ())])
def test_packed_partials_of_tiny_planes(n, radices):
    """Planes too small for a thread's 16 slots in one partial's rows: the
    block holds more rows than a partial (the kernel reduces each
    partial's rows from its output), and its partials are still one per
    rows_per_block rows."""
    for m in (1, 2, 4):
        plan = tfk.r_plan(n, radices, m, True, packed=True)
        pg = tfk.rows_per_block(n, m)
        assert plan.rows > pg or plan.rows * n >= tfk.T_SLOTS
        x_re, x_im = _planes(m, n, 11 * m + n)
        out, mm = emulate_packed(x_re, x_im, True, radices)
        ref_out, ref_mm = tfk.fft_rows_packed_out_plain(x_re[None], x_im[None])
        assert mm.shape == (m // pg, 4)
        assert torch.equal(out, ref_out) and torch.equal(mm, ref_mm)


def _whole_segments(words) -> bool:
    """Whether a warp's float offsets cover each 32-byte segment they touch
    whole (8 floats)."""
    words = np.unique(np.asarray(words).ravel())
    seg, count = np.unique(words // 8, return_counts=True)
    return bool((count == 8).all())


@pytest.mark.parametrize("n,radices", [(n, ()) for n in POW2] + SMOOTH)
def test_row_plan_maps_every_element_once_within_bank_limits(n, radices):
    """Each group's slots cover the block's rows x n elements once, inside
    the padded rows; the groups that touch device memory keep the along
    map; the exchanges stay within 2 threads a bank (4 in one group of the
    one-row blocks at n >= 8192), the natural ordering's bit-reversed
    stores within 2^(log2 n - 10) (2 at n = 2048; on no restore path)."""
    orders = [(False, False), (True, False)] + ([] if radices else [(False, True), (True, True)])
    for inverse, natural in orders:
        plan = tfk.r_plan(n, radices, 1 << 20, inverse, natural)
        assert sum(k for _, k, _, _ in plan.groups) == plan.logq
        assert plan.rows == max(1, 16 >> plan.logq) or 8 * n * plan.rows <= tfk.R_SMEM_BUDGET
        assert plan.smem_bytes <= tfk.MAX_BLOCK_SMEM and plan.threads <= tfk.R_THREADS
        last = len(plan.groups) - 1
        for g, group in enumerate(plan.groups):
            brev = natural and g == last
            row, col = tfk.t_slot_index(plan, group, brev)
            flat = np.sort((row * n + col).ravel())
            assert np.array_equal(flat, np.arange(plan.rows * n))
            assert (tfk.t_pad(col) < plan.rs).all()
            if tfk.r_pinned(len(plan.groups), g, bool(radices)):
                assert group[2] == 0  # along: ub first
            worst = tfk.t_bank_conflicts(plan, group, brev)
            limit = (1 << max(1, plan.logq - 10) if brev
                     else 4 if n >= 8192 else 2)
            assert worst <= limit, (inverse, natural, group, worst)


def test_row_plan_geometry():
    """128 threads a block; natural-store blocks of 2 rows at n = 2048 and
    1 at 2304-4096 (32 KB), packed-store blocks of one min/max partial's
    rows (4 at 2048, 2 at 3840), at least 16 / q rows."""
    assert tfk.r_plan(2048).rows == 2 and tfk.r_plan(2048).threads == 128
    assert tfk.r_plan(2304, (3, 3)).rows == 1 and tfk.r_plan(4096).rows == 1
    assert tfk.r_plan(2048, packed=True).rows == 4 == tfk.rows_per_block(2048, 1 << 20)
    assert tfk.r_plan(3840, (3, 5), 2304, True, packed=True).rows == 2
    assert tfk.r_plan(256, (), 256, True, packed=True).rows == 16
    assert tfk.r_plan(2, (), 4, True, packed=True).rows == 8  # 16 slots a thread
    assert tfk.r_plan(8, (), 4).threads == 32


@pytest.mark.parametrize("n,radices", [(n, ()) for n in POW2 if n >= 64] + SMOOTH)
def test_row_plan_device_access_whole_segments(n, radices):
    """A warp's direct loads and stores cover whole 32-byte segments: per
    slot for the row maps (the forward load, the inverse and natural
    store, the bit-reversed load), per item for the vector maps (its 2^k
    consecutive columns), per element for the cross passes' items."""
    orders = [(False, False), (True, False)] + ([] if radices else [(False, True), (True, True)])
    for inverse, natural in orders:
        plan = tfk.r_plan(n, radices, 1 << 20, inverse, natural)
        last = len(plan.groups) - 1
        for g, group in enumerate(plan.groups):
            if not tfk.r_pinned(len(plan.groups), g, bool(radices)):
                continue
            brev = natural and g == last
            row, col = tfk.t_slot_index(plan, group, brev)
            if brev:
                col = tfk.brev_columns(col, plan.logq)
            words = row * n + col
            e = 1 << group[1]
            for w in range(0, plan.slot_sets, 32):
                lanes = words[w:w + 32]
                accesses = []
                if g == last and not natural:  # the bottom group's vectors
                    accesses += [lanes[:, a:a + e] for a in range(0, tfk.T_SLOTS, e)]
                if g == 0 and not radices or brev:  # the row maps, slot by slot
                    accesses += [lanes[:, j] for j in range(tfk.T_SLOTS)]
                for acc in accesses:
                    assert _whole_segments(acc), (inverse, natural, group, w)
        if radices:  # the cross passes: item (row, b), b fastest
            q = 1 << plan.logq
            items = np.arange(plan.rows * q)
            words = ((items >> plan.logq)[:, None] * n
                     + tfk.t_cross_columns(plan, radices)[items & (q - 1)])
            for w in range(0, len(items), 32):
                for j in range(words.shape[1]):
                    assert _whole_segments(words[w:w + 32, j])


@pytest.mark.parametrize("n,radices,inverse,ordering", [
    (n, rad, inv, order) for n, rad in [(256, ()), (2048, ()), (3840, (3, 5))]
    for inv in (False, True) for order in (("revorder",) if rad else ("revorder", "natural"))])
def test_row_plan_emulation_matches_jax_fft_rows(n, radices, inverse, ordering):
    x_re, x_im = _planes(8, n, 13 * n + inverse)
    ref = jfk.fft_rows_pallas(jnp.asarray(x_re.numpy()[None]), jnp.asarray(x_im.numpy()[None]),
                              inverse, ordering=ordering, engine="roll", radices=radices)
    ours = emulate_rows(x_re, x_im, inverse, radices, ordering == "natural")
    for o, r in zip(ours, ref):
        r = np.asarray(r)[0]
        assert o.shape == r.shape
        assert np.abs(o.numpy() - r).max() <= REL * max(float(np.abs(r).max()), 1e-30)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,radices", [(256, ()), (2048, ()), (3840, (3, 5))])
def test_packed_emulation_matches_jax_packed_out(n, radices, inverse):
    """The packed store and its partials against the JAX
    fft_rows_packed_out: the planes at the file's tolerance; the partials
    (the JAX kernel's blocks are its own) through the per-plane min/max
    that the pipeline takes from them."""
    x_re, x_im = _planes(8, n, 17 * n + inverse)
    ref, ref_mm = jfk.fft_rows_packed_out(
        jnp.asarray(x_re.numpy()[None]), jnp.asarray(x_im.numpy()[None]), inverse,
        ordering="revorder", emit_minmax=True, engine="roll", radices=radices)
    out, mm = emulate_packed(x_re, x_im, inverse, radices)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= REL * float(np.abs(ref).max())
    ref_mm = np.asarray(ref_mm).reshape(-1, 4)
    for col, red in ((0, np.min), (1, np.max), (2, np.min), (3, np.max)):
        assert abs(red(mm.numpy()[:, col]) - red(ref_mm[:, col])) <= REL * float(np.abs(ref).max())
