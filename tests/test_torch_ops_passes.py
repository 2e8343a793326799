"""The ops layer's FFT kernels' plans emulated group by group on the CPU.

B11 (csrc/fft_cols.cu, `fft_kernel.col_plan`) runs the column stages of
a strip of columns in register groups of <= 4 stages (16 complex values a
thread) and exchanges them through a swizzled shared-memory strip once a
group; B12 (csrc/fft_radix4.cu, `fft_radix4.r4_plan`) runs two radix-4
stages a group, the radix-2 tail folded into the last one. Only the card
runs that index math, so these tests run it here in plain torch: the
emulations below gather each group's slots from device memory (the first
group: B11's row map, its natural ordering's bit-reversed rows; B12's
top group, a real input reading no imaginary part) or from the shared
image at the plan's addresses, run the group's butterflies slot by slot
with the tables, and scatter them to the output (the last group) or back
to the image, as the kernels do. Each emulation must be BITWISE equal to
the plain version (`fft_cols_plain`, `fft_rows_radix4_fwd_plain`: the
same float32 operations in the same order), B11 at every pow2 H from 2
to 4096 in both orderings and directions with a ragged last strip, B12
at every n from 4 to 4096, real and complex; and it must match the JAX
kernels (interpret mode: fft_cols_pallas, fft_rows_radix4_fwd) at the
tolerance of tests/test_torch_ops_kernels.py. The plans' element maps
(each element loaded and stored once), bank conflicts and device
accesses (whole 32-byte segments a warp) are checked here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import fft_radix4 as jr4
from fft_restoration_tpu.ops.pallas.fft_kernel import fft_cols_pallas
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as tr4

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

REL = 1e-5
POW2_H = [1 << s for s in range(1, 13)]           # B11: 2 .. 4096
POW2_N = [1 << s for s in range(2, 13)]           # B12: 4 .. 4096
COL_MODES = ("revorder_fwd", "revorder_inv", "natural_fwd", "natural_inv")


def _whole_segments(words) -> bool:
    """Whether a warp's float offsets cover each 32-byte segment they touch
    whole (8 floats)."""
    words = np.unique(np.asarray(words).ravel())
    _, count = np.unique(words // 8, return_counts=True)
    return bool((count == 8).all())


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 for _ in range(2))


# ---------------------------------------------------------------------------
# B11: the column stage groups


def _col_group(smem, src, plan, group, tab, dit, dst=None, brev=False):
    """One column stage group over every strip: gather the slots (from src
    = (re, im) strips (B, H, cols), a device load, its rows bit-reversed
    for brev; else from the swizzled shared image), the group's
    butterflies, scatter (to dst, the device store; else to the image)."""
    s_lo, k = group
    row, c = tfk.col_slot_index(plan, group)
    addr = torch.from_numpy(tfk.col_row(plan, row) * plan.cols + c)
    row_t, c_t = torch.from_numpy(row), torch.from_numpy(np.array(c))
    if src is not None:
        dev = torch.from_numpy(tfk.brev_columns(row, plan.logh)) if brev else row_t
        xr, xi = (x[:, dev, c_t] for x in src)
    else:
        xr, xi = smem[0][:, addr], smem[1][:, addr]
    xr, xi = list(xr.unbind(-1)), list(xi.unbind(-1))
    lo = torch.from_numpy(row & ((1 << s_lo) - 1))
    for b in (range(k) if dit else range(k - 1, -1, -1)):
        s = s_lo + b
        for j in range(tfk.T_SLOTS):
            jl = j & ((1 << k) - 1)
            if jl & (1 << b):
                continue
            j2 = j + (1 << b)
            pos = lo[:, j] + ((jl & ((1 << b) - 1)) << s_lo)
            cw, sn = tab.cos[s][pos], tab.sin[s][pos]
            ar, ai, br, bi = xr[j], xi[j], xr[j2], xi[j2]
            if dit:
                wr, wi = cw * br - sn * bi, cw * bi + sn * br
                xr[j], xi[j], xr[j2], xi[j2] = ar + wr, ai + wi, ar - wr, ai - wi
            else:
                dr, di = ar - br, ai - bi
                xr[j], xi[j] = ar + br, ai + bi
                xr[j2], xi[j2] = cw * dr - sn * di, cw * di + sn * dr
    if dst is not None:
        for o, v in zip(dst, (xr, xi)):
            o[:, row_t, c_t] = torch.stack(v, -1)
    else:
        smem[0][:, addr] = torch.stack(xr, -1)
        smem[1][:, addr] = torch.stack(xi, -1)


def emulate_cols(x_re, x_im, inverse, natural, cols=0):
    """fft_cols' plan (csrc/fft_cols.cu) on (L, H, W) float32 planes: the
    strips of col_plan's columns (a ragged last strip reads zeros and
    stores nothing), each group in order (DIF top down for revorder
    forward; DIT bottom up otherwise, natural's first group loading the
    bit-reversed rows); (L, H, W) out."""
    lead, h, w = x_re.shape
    plan = tfk.col_plan(h, w, cols)
    tab = tfk.tables(h, inverse, torch.device("cpu"))
    c = plan.cols
    nstrip = -(-w // c)

    def strips(x):
        x = torch.nn.functional.pad(x, (0, nstrip * c - w))
        return x.reshape(lead, h, nstrip, c).permute(0, 2, 1, 3).reshape(-1, h, c)

    src = [strips(x) for x in (x_re, x_im)]
    smem = [torch.full((lead * nstrip, h * c), float("nan")) for _ in range(2)]
    out = [torch.full((lead * nstrip, h, c), float("nan")) for _ in range(2)]
    dit = inverse or natural
    order = list(reversed(plan.groups)) if dit else list(plan.groups)
    for g, group in enumerate(order):
        _col_group(smem, src if g == 0 else None, plan, group, tab, dit,
                   out if g == len(order) - 1 else None, natural and g == 0)
    return tuple(o.reshape(lead, nstrip, h, c).permute(0, 2, 1, 3).reshape(lead, h, -1)[..., :w]
                 for o in out)


@pytest.mark.parametrize("mode", COL_MODES)
@pytest.mark.parametrize("h", POW2_H)
def test_col_plan_emulation_bitwise_equals_plain(h, mode):
    """Every ordering and direction of fft_cols' plan, group by group, is
    fft_cols_plain bit for bit, on planes with a ragged last strip."""
    natural, inverse = mode.startswith("natural"), mode.endswith("inv")
    cols = tfk.cols_per_block(h, 1 << 20)
    lead, w = (2, 2 * cols + 3) if h <= 256 else (1, cols + 3)
    x_re, x_im = _planes((lead, h, w), h + 2 * inverse + natural)
    ours = emulate_cols(x_re, x_im, inverse, natural)
    ref = tfk.fft_cols_plain(x_re, x_im, inverse=inverse,
                             ordering="natural" if natural else "revorder")
    for o, r in zip(ours, ref):
        assert torch.equal(o, r), float((o - r).abs().max())


@pytest.mark.parametrize("cols", [1, 2, 4, 8, 16, 32])
def test_col_plan_emulation_other_strips(cols):
    """The strip widths rows_geometry's --cols sweep takes, at H = 64."""
    x_re, x_im = _planes((2, 64, 37), cols)
    for inverse, natural in ((False, False), (True, True)):
        ours = emulate_cols(x_re, x_im, inverse, natural, cols)
        ref = tfk.fft_cols_plain(x_re, x_im, inverse=inverse,
                                 ordering="natural" if natural else "revorder")
        assert all(torch.equal(o, r) for o, r in zip(ours, ref))


def _col_cases():
    for s in range(1, 15):
        h = 1 << s
        for cols in (1, 2, 4, 8, 16, 32):
            if h * cols >= tfk.T_SLOTS and 8 * h * cols <= tfk.MAX_BLOCK_SMEM:
                yield h, cols


@pytest.mark.parametrize("h,cols", list(_col_cases()))
def test_col_plan_maps_every_element_once_within_bank_limits(h, cols):
    """Each group's slots cover the strip's h x cols elements once, and the
    swizzled shared rows are a permutation of the strip's; S stages take
    ceil(S / 4) groups, so ceil(S / 4) - 1 exchanges; every exchange is
    conflict-free (1 thread a bank), except the middle group of H = 2048
    on strips of 1 or 2 columns (2)."""
    plan = tfk.col_plan(h, 1 << 20, cols)
    assert len(plan.groups) == -(-plan.logh // 4)
    assert sum(k for _, k in plan.groups) == plan.logh
    for group in plan.groups:
        row, c = tfk.col_slot_index(plan, group)
        assert np.array_equal(np.sort((row * cols + c).ravel()), np.arange(h * cols))
        phys = tfk.col_row(plan, row) * cols + c
        assert np.array_equal(np.sort(phys.ravel()), np.arange(h * cols))
        limit = 2 if h == 2048 and cols <= 2 else 1
        assert tfk.col_bank_conflicts(plan, group) <= limit, (group, cols)


@pytest.mark.parametrize("h", [1 << s for s in range(4, 15)])
def test_col_plan_device_access_whole_segments(h):
    """A warp's device loads and stores cover whole 32-byte segments, slot
    by slot, on strips of >= 8 columns (4 rows of 8 floats per slot), the
    natural ordering's bit-reversed rows too. The stated exception: from H
    = 4096 the strip is narrower (4 columns at 4096 in 128 KB of shared
    memory, 2 at 8192, 1 at 16384), and a warp then covers whole row
    segments of the strip's width, whose other part the next strip's
    block reads."""
    w = 64
    plan = tfk.col_plan(h, w)
    assert plan.cols >= 8 if h <= 2048 else plan.cols == 4 * 4096 // h
    seg = min(plan.cols, 8)
    for group in (plan.groups[0], plan.groups[-1]):
        row, c = tfk.col_slot_index(plan, group)
        for brev in (False, True):
            rows = tfk.brev_columns(row, plan.logh) if brev else row
            words = rows * w + c  # strip 0; every strip is this + a multiple of cols
            for u in range(0, plan.slot_sets, 32):
                for j in range(tfk.T_SLOTS):
                    lanes = np.unique(words[u:u + 32, j])
                    _, count = np.unique(lanes // seg, return_counts=True)
                    assert (count == seg).all(), (group, brev, u, j)


def test_col_plan_geometry():
    """8 columns a strip at H = 2048 (128 KB), 4 at 4096; a strip holds at
    least 16 / H columns; two slot sets a thread, up to 512 threads; 3
    groups (2 exchanges) at 2048 and 4096."""
    assert tfk.col_plan(2048, 2048).cols == 8 and tfk.col_plan(4096, 2048).cols == 4
    assert tfk.col_plan(2048, 2048).groups == ((7, 4), (3, 4), (0, 3))
    assert tfk.col_plan(4096, 2048).groups == ((8, 4), (4, 4), (0, 4))
    assert tfk.col_plan(2048, 2048).smem_bytes == 128 << 10
    assert tfk.col_plan(2, 1).cols == 8 and tfk.col_plan(8, 1).cols == 2
    assert tfk.col_plan(16, 5).smem_bytes == 0  # one group: no exchange
    assert tfk.col_plan(2048, 2048).threads == 512 == tfk.C_THREADS
    assert tfk.col_plan(256, 256).threads == 256 and tfk.col_plan(2, 5).threads == 32
    with pytest.raises(ValueError, match="strip columns"):
        tfk.col_plan(4, 4, 2)
    with pytest.raises(ValueError, match="threads"):
        tfk.col_plan(256, 256, 8, 48)
    with pytest.raises(ValueError, match="threads"):
        tfk.col_plan(2048, 2048, 8, 1024)


@pytest.mark.parametrize("ordering", ["natural", "revorder"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("h,w", [(64, 37), (256, 24)])
def test_col_emulation_matches_jax_fft_cols(h, w, inverse, ordering):
    x_re, x_im = _planes((2, h, w), 3 * h + w + inverse)
    ref = fft_cols_pallas(jnp.asarray(x_re.numpy()), jnp.asarray(x_im.numpy()), inverse,
                          ordering=ordering)
    ours = emulate_cols(x_re, x_im, inverse, ordering == "natural")
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        assert np.abs(o.numpy() - r).max() <= REL * scale


# ---------------------------------------------------------------------------
# B12: the radix-4 stage groups


def _radix4(xr, xi, slots, lanes, wc, ws):
    """One radix-4 DIF butterfly on the values of four slots (a, b, c, d),
    each output y_k times the table at its lane (the JAX order)."""
    a, b, c, d = slots
    t1r, t1i = xr[a] + xr[c], xi[a] + xi[c]
    t2r, t2i = xr[a] - xr[c], xi[a] - xi[c]
    t3r, t3i = xr[b] + xr[d], xi[b] + xi[d]
    t4r, t4i = xr[b] - xr[d], xi[b] - xi[d]
    yr = (t1r + t3r, t2r + t4i, t1r - t3r, t2r - t4i)
    yi = (t1i + t3i, t2i - t4r, t1i - t3i, t2i + t4r)
    for k, s in enumerate(slots):
        cw, sw = wc[lanes[s]], ws[lanes[s]]
        xr[s], xi[s] = yr[k] * cw - yi[k] * sw, yr[k] * sw + yi[k] * cw


def _r4_group(smem, src, plan, group, tabs, dst=None):
    """One radix-4 group over every block: gather (from src = (re, im)
    blocks of rows, re only for a real input; else the padded shared
    image), the group's stages, scatter (to dst, else the image)."""
    ll, le, _ = group
    e_n, ld = 1 << le, ll - le
    row, col = tr4.r4_slot_index(plan, group)
    addr = torch.from_numpy(row * plan.rs + tfk.t_pad(col))
    row_t, col_t = torch.from_numpy(row), torch.from_numpy(col)
    if src is not None:
        xr = src[0][:, row_t, col_t]
        xi = torch.zeros_like(xr) if src[1] is None else src[1][:, row_t, col_t]
    else:
        xr, xi = smem[0][:, addr], smem[1][:, addr]
    xr, xi = list(xr.unbind(-1)), list(xi.unbind(-1))
    c4, s4, c2, s2 = tabs
    s = (plan.log2n - ll) // 2  # the group's first radix-4 stage
    lane = torch.from_numpy(col & ((1 << ll) - 1))  # the kernel's (e << ld) | j
    sub = torch.from_numpy(col & ((1 << (ll - 2)) - 1)) if le == 4 else None
    for base in range(0, tfk.T_SLOTS, e_n):
        lanes = {base + e: lane[:, base + e] for e in range(e_n)}
        if le == 4:
            for k2 in range(4):
                _radix4(xr, xi, [base + 4 * k + k2 for k in range(4)], lanes, c4[s], s4[s])
            sub_lanes = {base + e: sub[:, base + e] for e in range(e_n)}
            for k1 in range(4):
                _radix4(xr, xi, [base + 4 * k1 + k for k in range(4)], sub_lanes, c4[s + 1],
                        s4[s + 1])
        elif le >= 2:
            for m in range(e_n // 4):
                _radix4(xr, xi, [base + m + k * (e_n // 4) for k in range(4)], lanes, c4[s],
                        s4[s])
        if le in (1, 3):  # the radix-2 tail: pairs of consecutive slots
            for p in range(base, base + e_n, 2):
                ar, ai, br, bi = xr[p], xi[p], xr[p + 1], xi[p + 1]
                dr, di = ar - br, ai - bi
                xr[p], xi[p] = ar + br, ai + bi
                xr[p + 1], xi[p + 1] = c2 * dr - s2 * di, c2 * di + s2 * dr
    if dst is not None:
        for o, v in zip(dst, (xr, xi)):
            o[:, row_t, col_t] = torch.stack(v, -1)
    else:
        smem[0][:, addr] = torch.stack(xr, -1)
        smem[1][:, addr] = torch.stack(xi, -1)


def emulate_radix4(x_re, x_im):
    """fft_radix4's plan (csrc/fft_radix4.cu) on (M, n) float32 rows
    (x_im None: a real input): (M, n) out."""
    m, n = x_re.shape
    plan = tr4.r4_plan(n, m)
    rows = plan.rows
    nblk = -(-m // rows)

    def blocks(x):
        return torch.zeros(nblk * rows, n).index_copy(0, torch.arange(m), x).reshape(nblk, rows, n)

    src = (blocks(x_re), None if x_im is None else blocks(x_im))
    c4, s4 = (torch.from_numpy(a) for a in tr4._r4_tables_np(n)[:2])
    t2 = tfk.tables(n, False, torch.device("cpu"))
    tabs = (c4, s4, t2.cos[0][0], t2.sin[0][0])
    smem = [torch.full((nblk, rows * plan.rs), float("nan")) for _ in range(2)]
    out = [torch.full((nblk, rows, n), float("nan")) for _ in range(2)]
    last = len(plan.groups) - 1
    for g, group in enumerate(plan.groups):
        _r4_group(smem, src if g == 0 else None, plan, group, tabs, out if g == last else None)
    return tuple(o.reshape(-1, n)[:m] for o in out)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("n", POW2_N)
def test_r4_plan_emulation_bitwise_equals_plain(n, real):
    """fft_radix4's plan, group by group, is fft_rows_radix4_fwd_plain bit
    for bit, on a ragged last row block."""
    plan = tr4.r4_plan(n, 1 << 20)
    m = 2 * plan.rows + 1
    x_re, x_im = _planes((m, n), 2 * n + real)
    ours = emulate_radix4(x_re, None if real else x_im)
    ref = tr4.fft_rows_radix4_fwd_plain(x_re, None if real else x_im)
    for o, r in zip(ours, ref):
        assert torch.equal(o, r), float((o - r).abs().max())


def test_r4_stage_groups():
    """Two radix-4 stages a group; n = 2048's five and its radix-2 tail in
    three groups (2 exchanges, against the shared-memory kernel's 6
    passes); 4^a none; the small lengths one group."""
    assert tr4.r4_stage_groups(2048) == ((11, 4), (7, 4), (3, 3))
    assert tr4.r4_stage_groups(4096) == ((12, 4), (8, 4), (4, 4))
    assert tr4.r4_stage_groups(1024) == ((10, 4), (6, 4), (2, 2))
    assert tr4.r4_stage_groups(512) == ((9, 4), (5, 4), (1, 1))
    assert [tr4.r4_stage_groups(n) for n in (4, 8, 16)] == [((2, 2),), ((3, 3),), ((4, 4),)]
    assert tr4.r4_plan(2048).rows == 2 and tr4.r4_plan(2048).threads == tr4.R4_PLAN_THREADS
    assert tr4.r4_plan(4, 2).rows == 4 and tr4.r4_plan(16, 3).smem_bytes == 0


@pytest.mark.parametrize("n", [1 << s for s in range(2, 15)])
def test_r4_plan_maps_every_element_once_within_bank_limits(n):
    """Each group's slots cover the block's rows x n elements once, inside
    the padded rows; the top and bottom groups keep the plain map; every
    exchange is conflict-free at n >= 1024 and within 2 threads a bank
    below (the top group's short items at n = 32-256, n = 512's middle)."""
    plan = tr4.r4_plan(n, 1 << 20)
    assert sum(le for _, le, _ in plan.groups) == plan.log2n
    assert plan.smem_bytes <= tfk.MAX_BLOCK_SMEM
    for g, group in enumerate(plan.groups):
        row, col = tr4.r4_slot_index(plan, group)
        assert np.array_equal(np.sort((row * n + col).ravel()), np.arange(plan.rows * n))
        assert (tfk.t_pad(col) < plan.rs).all()
        if g in (0, len(plan.groups) - 1):
            assert group[2] == 0  # unrotated
        assert tr4.r4_bank_conflicts(plan, group) <= (1 if n >= 1024 else 2), group


@pytest.mark.parametrize("n", [1 << s for s in range(7, 15)])
def test_r4_plan_device_access_whole_segments(n):
    """A warp's device loads (the top group, slot by slot) and vector
    stores (the bottom group, an item's E consecutive elements) cover
    whole 32-byte segments."""
    plan = tr4.r4_plan(n, 1 << 20)
    for g in (0, len(plan.groups) - 1):
        row, col = tr4.r4_slot_index(plan, plan.groups[g])
        words = row * n + col
        e_n = 1 << plan.groups[g][1]
        for u in range(0, plan.slot_sets, 32):
            lanes = words[u:u + 32]
            if g == 0:
                accesses = [lanes[:, j] for j in range(tfk.T_SLOTS)]
            else:
                assert (np.diff(lanes.reshape(-1, e_n), axis=1) == 1).all()
                accesses = [lanes[:, a:a + e_n] for a in range(0, tfk.T_SLOTS, e_n)]
            for acc in accesses:
                assert _whole_segments(acc), (g, u)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("n", [32, 128])
def test_r4_emulation_matches_jax(n, real):
    x_re, x_im = _planes((5, n), 5 * n + real)
    ref = jr4.fft_rows_radix4_fwd(jnp.asarray(x_re.numpy()),
                                  None if real else jnp.asarray(x_im.numpy()))
    ours = emulate_radix4(x_re, None if real else x_im)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for o, r in zip(ours, ref):
        assert np.abs(o.numpy() - np.asarray(r)).max() <= REL * scale
