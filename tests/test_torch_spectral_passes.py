"""The spectral middles' stage plans (B2, B7, B10) emulated on the CPU.

B2 (wiener_spectral_t, spectral_conv_t), B7 (fwd_wiener_rows) and B10
(wiener_spectral_rows) run in csrc/wiener_spectral.cu on the stage-group
engine of B1 and B3/B6 (csrc/fft_groups.cuh), after `fft_kernel.s_plan`:
the DIF groups top down (the top one loading device memory at a pow2
length, a smooth row loading through its cross levels), the bottom
group's DIF stages, the filter against H's slots of each item's row and
(B2, B10) its DIT stages in one register pass, the DIT groups bottom up
(the top one storing B2's transposed or B10's row-major output from
registers at a pow2 length, a smooth row storing through its inverse
cross levels), B7's bottom group storing its filtered items in natural
order. Only the card runs that index math, so
the emulation below runs it here with tests/test_torch_fft_passes.py's
helpers: each group gathers its slots at the plan's addresses, runs its
butterflies slot pair by slot pair and scatters them, the filter runs
on the bottom group's slots. Each emulation must be BITWISE equal to
the plain version (the same float32 operations in the same order) in
every mode at every pow2 n from 2 to 16384 and at the smooth lengths (B10
pow2 only), with a ragged last row block; and it must match the JAX
package's kernels (interpret mode, engine="roll": wiener_spectral_rows_t
in both its modes, fwd_wiener_rows_pallas, wiener_spectral_rows_pallas)
at the tolerance of tests/test_torch_wiener_spectral.py. The plans' maps, bank conflicts,
device accesses (whole 32-byte segments) and H's vector alignment are
checked here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fft_passes import POW2, REL, SMOOTH, _cross, _group, _whole_segments

from fft_restoration_tpu.ops.pallas.fft_kernel import fft_rows_pallas
from fft_restoration_tpu.ops.pallas.wiener_spectral import (
    fwd_wiener_rows_pallas,
    wiener_spectral_rows_pallas,
    wiener_spectral_rows_t,
)
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as tws
from fft_restoration_tpu_torch.ops.wiener import spectral_product, wiener_filter

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

MODES = ("wiener", "conv", "conv_conj", "b7", "b10")
# each mode's s_plan store
STORE = {"wiener": "transposed", "conv": "transposed", "conv_conj": "transposed",
         "b7": "natural", "b10": "rows"}
K = 0.05
CPU = torch.device("cpu")


def _filter(mode, g, h):
    if mode in ("wiener", "b7", "b10"):
        return wiener_filter(g, h, K)
    return spectral_product(g, h, mode == "conv_conj")


def _blocks(x, nblk, rows):
    """(P, M, n) planes -> (P * nblk, rows, n) row blocks, zero past M."""
    p, m, n = x.shape
    out = torch.zeros(p, nblk * rows, n).index_copy(1, torch.arange(m), x)
    return out.reshape(p * nblk, rows, n)


def _unblock(x, p, m):
    """(P * nblk, rows, n) row blocks -> (P, M, n) live rows."""
    return x.reshape(p, -1, x.shape[-1])[:, :m]


def emulate_spectral(a_re, a_im, h_re, h_im, mode, radices=()):
    """One launch of B2 (mode 'wiener', 'conv', 'conv_conj'), B7 ('b7') or
    B10 ('b10') on (P, M, n) float32 planes and the (M, n) spectrum, at
    s_plan's addresses: B2's (P, n, M) output, B7's and B10's (P, M, n)."""
    p, m, n = a_re.shape
    b7 = mode == "b7"
    plan = tfk.s_plan(n, radices, m, STORE[mode])
    tf = tfk.tables(n, False, CPU, radices)
    ti = tfk.tables(n, True, CPU, radices)
    rows, q = plan.rows, 1 << plan.logq
    nblk = -(-m // rows)
    blocks = [_blocks(x, nblk, rows) for x in (a_re, a_im)]
    h_blocks = [_blocks(x[None], nblk, rows).repeat(p, 1, 1) for x in (h_re, h_im)]
    # the shared image, NaN where no slot was written
    sre, sim = (torch.full((p * nblk, rows * plan.rs), float("nan")) for _ in range(2))
    out = [torch.full((p * nblk, rows, n), float("nan")) for _ in range(2)]
    cols = tfk.t_cross_columns(plan, radices)
    rr = np.arange(rows)[:, None, None]
    item_addr = torch.from_numpy(rr * plan.rs + tfk.t_pad(cols[None]))  # (rows, q, R)
    src = blocks
    if not plan.direct_store:  # load (+ both cross levels), item (row, b)
        xr, xi = (x[:, torch.from_numpy(rr), torch.from_numpy(cols)] for x in blocks)
        if radices:
            xr, xi = _cross(xr, xi, radices, tf, torch.arange(q), q, False)
        sre[:, item_addr], sim[:, item_addr] = xr, xi
        src = None
    last = len(plan.groups) - 1
    for g in range(last):
        _group(sre, sim, src if g == 0 else None, plan, plan.groups[g], tf, False)
    # the fused bottom group: its DIF stages, the filter on its slots, and
    # (B2) its DIT stages; in registers on the card, through the image here
    bottom = plan.groups[last]
    _group(sre, sim, None, plan, bottom, tf, False)
    row, col = tfk.t_slot_index(plan, bottom)
    addr = torch.from_numpy(row * plan.rs + tfk.t_pad(col))
    row, col = torch.from_numpy(row), torch.from_numpy(col)
    f = _filter(mode, (sre[:, addr], sim[:, addr]), tuple(h[:, row, col] for h in h_blocks))
    if b7:
        for o, v in zip(out, f):
            o[:, row, col] = v
        return tuple(_unblock(o, p, m) for o in out)
    sre[:, addr], sim[:, addr] = f
    _group(sre, sim, None, plan, bottom, ti, True)
    # the top DIT group of a direct plan stores from registers: B2's blocks
    # of rows, transposed below; B10's row-major ST_ROW
    for g in range(last - 1, -1, -1):
        direct = plan.direct_store and g == 0
        _group(sre, sim, None, plan, plan.dit_groups[g], ti, True, out if direct else None)
    if not plan.direct_store:  # (both inverse cross levels, then) the store
        xr, xi = sre[:, item_addr], sim[:, item_addr]
        if radices:
            xr, xi = _cross(xr, xi, radices, ti, torch.arange(q), q, True)
        idx = torch.from_numpy(cols.reshape(-1))
        for o, v in zip(out, (xr, xi)):
            o[:, :, idx] = v.reshape(p * nblk, rows, -1)
    if mode == "b10":
        return tuple(_unblock(o, p, m) for o in out)
    return tuple(_unblock(o, p, m).transpose(1, 2).contiguous() for o in out)


def _plain(mode, a_re, a_im, h_re, h_im, radices):
    if mode == "b7":
        return tws.fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, K, radices)
    if mode == "b10":
        return tws.wiener_spectral_rows_plain(a_re, a_im, h_re, h_im, K)
    if mode == "wiener":
        return tws.wiener_spectral_t_plain(a_re, a_im, h_re, h_im, K, radices)
    return tws.spectral_conv_t_plain(a_re, a_im, h_re, h_im, mode == "conv_conj", radices)


def _operands(m, n, seed):
    rng = np.random.default_rng(seed)
    a = [torch.from_numpy(rng.standard_normal((2, m, n), dtype=np.float32)) for _ in range(2)]
    h = [torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)) for _ in range(2)]
    return (*a, *h)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,radices", [(n, ()) for n in POW2] + SMOOTH)
def test_spectral_emulation_bitwise_equals_plain(n, radices, mode):
    """Every mode of the plan, group by group, is the plain version bit for
    bit, at a plane height that leaves a ragged last row block; B10's row
    store refuses a smooth row (the JAX kernel takes pow2 rows only)."""
    m = 3 if n >= 8192 else 11 if n >= 1024 else 21
    ops = _operands(m, n, 3 * n + MODES.index(mode))
    if mode == "b10" and radices:
        with pytest.raises(ValueError, match="power-of-two"):
            emulate_spectral(*ops, mode, radices)
        return
    ours = emulate_spectral(*ops, mode, radices)
    ref = _plain(mode, *ops, radices)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        assert torch.equal(o, r), float((o - r).abs().max())


def _plans(n, radices):
    """{store: plan} of each store that takes the length."""
    return {store: tfk.s_plan(n, radices, 1 << 20, store) for store in tfk.S_STORES
            if not (store == "rows" and radices)}


@pytest.mark.parametrize("n,radices", [(n, ()) for n in POW2] + SMOOTH)
def test_spectral_plan_maps_every_element_once_within_bank_limits(n, radices):
    """Each group's slots, in either pass, cover the block's rows x n
    elements once, inside the padded rows; the pinned groups keep the
    along map, B2's top DIT group of a direct plan the across map, B10's
    DIT groups their DIF maps (its top one, storing the rows, the along
    map); the exchanges stay within 2 threads a bank (4 in one group at n
    >= 8192: blocks of one or two rows)."""
    for store, plan in _plans(n, radices).items():
        transposed = store == "transposed"
        assert sum(k for _, k, _, _ in plan.groups) == plan.logq
        assert plan.smem_bytes <= tfk.MAX_BLOCK_SMEM and plan.threads <= tfk.T_THREADS
        assert plan.direct_store == (not radices and len(plan.groups) > 1)
        assert bool(plan.dit_groups) == (store != "natural")
        if plan.dit_groups:
            assert [g[:2] for g in plan.dit_groups] == [g[:2] for g in plan.groups]
            assert plan.dit_groups[-1] == plan.groups[-1]  # one fused bottom group
        if store == "rows":
            assert plan.dit_groups == plan.groups
        for g, group in enumerate(plan.groups + plan.dit_groups):
            row, col = tfk.t_slot_index(plan, group)
            flat = np.sort((row * n + col).ravel())
            assert np.array_equal(flat, np.arange(plan.rows * n))
            assert (tfk.t_pad(col) < plan.rs).all()
            worst = tfk.t_bank_conflicts(plan, group)
            assert worst <= (4 if n >= 8192 else 2), (plan.rows, group, worst)
        for g, (s_lo, k, ub_shift, _) in enumerate(plan.groups):
            if tfk.s_pinned(len(plan.groups), g, k, plan.direct_store) and plan.lr:
                assert ub_shift == 0  # along: ub first
        if transposed and plan.direct_store and plan.lr:
            assert plan.dit_groups[0][3] == 0  # across: row first


def test_spectral_plan_geometry():
    """B2: 8 rows a block at n = 2048 and 2304 (32-byte column segments),
    4 at 3840 and 4096, 512 threads, fewer rows for launches of few pairs
    down to 8; B7 and B10: the rows of 32 KB (16 at n = 256, 2 at 2048),
    128 threads; every thread's 16 slots full (a `rows` below that takes
    16 / q), at most the next power of two >= the plane height; 3 groups
    at n = 2048, 2 at 256 and 2304; B10 pow2 only."""
    assert tfk.s_plan(2048).rows == 8 and tfk.s_plan(2304, (3, 3)).rows == 8
    assert tfk.s_plan(3840, (3, 5)).rows == 4 and tfk.s_plan(4096).rows == 4
    assert tfk.s_plan(2048).threads == 512 and len(tfk.s_plan(2048).groups) == 3
    assert tfk.s_plan(512, (), 512, "transposed", 264).rows == 8
    b7 = tfk.s_plan(256, (), 256, "natural")
    assert b7.rows == 16 and b7.threads == 128 and len(b7.groups) == 2 and not b7.dit_groups
    assert len(tfk.s_plan(2304, (3, 3)).groups) == 2
    assert tfk.s_plan(2, (), 1, "natural").rows == 8 and tfk.s_plan(8, (), 3).rows == 4
    over = tfk.s_plan(2048, (), 64, "transposed", 0, 4, 128)  # tools/rows_geometry.py
    assert (over.rows, over.threads) == (4, 128)
    b10 = tfk.s_plan(2048, (), 2048, "rows")
    assert (b10.rows, b10.threads, len(b10.dit_groups)) == (2, 128, 3) and b10.direct_store
    assert tfk.s_plan(4, (), 7, "rows", 0, 1).rows == 4 and tfk.s_plan(16384, (), 7, "rows").rows == 1
    with pytest.raises(ValueError, match="power-of-two"):
        tfk.s_plan(2304, (3, 3), 64, "rows")
    with pytest.raises(ValueError):
        tfk.s_plan(2048, (), 64, "transposed", 0, 3)
    with pytest.raises(ValueError):
        tfk.s_plan(2048, (), 64, "sideways")


@pytest.mark.parametrize("n,radices", [(n, ()) for n in POW2 if n >= 64] + SMOOTH)
def test_spectral_plan_device_access(n, radices):
    """A warp's direct device accesses cover whole 32-byte segments: the
    top DIF group's row load (per slot), B10's row-major store from its top
    DIT group (per slot), B2's direct transposed store from the top DIT
    group (per slot, at n <= 2304) and the shared-memory
    transposed store (per element of an item, 8+ rows a block), B7's
    vector store and the H vectors of the bottom group (per item, or per
    slot for items narrower than a segment); H's vectors start 16-byte
    aligned (8-byte for 2-wide items)."""
    big_m = 1 << 12  # a plane height that is a multiple of every block
    for store, plan in _plans(n, radices).items():
        transposed = store == "transposed"
        bottom = plan.groups[-1]
        e = 1 << bottom[1]
        row, col = tfk.t_slot_index(plan, bottom)
        assert (col[:, ::e] % min(e, 4) == 0).all() and (n < 4 or n % 4 == 0)
        words = row * n + col
        for w in range(0, plan.slot_sets, 32):
            for a in range(0, tfk.T_SLOTS, e):
                assert _whole_segments(words[w:w + 32, a:a + e]), (plan, w, a)
        if plan.direct_store:
            # the top DIF group's row load; B10's row-major store (ST_ROW)
            # from its top DIT group
            tops = [plan.groups[0]] + ([plan.dit_groups[0]] if store == "rows" else [])
            for group in tops:
                row, col = tfk.t_slot_index(plan, group)
                for w in range(0, plan.slot_sets, 32):
                    for j in range(tfk.T_SLOTS):
                        assert _whole_segments((row * n + col)[w:w + 32, j]), (plan, w, j)
        if not transposed:
            continue
        assert plan.rows >= tfk.T_MIN_ROWS_STORE or n > 2304  # 16-byte segments past 2304
        if plan.rows < tfk.T_MIN_ROWS_STORE:
            continue
        if plan.direct_store:  # ST_T: output (column, row) at column * M + row
            row, col = tfk.t_slot_index(plan, plan.dit_groups[0])
            for w in range(0, plan.slot_sets, 32):
                for j in range(tfk.T_SLOTS):
                    assert _whole_segments((col * big_m + row)[w:w + 32, j]), (plan, w, j)
        else:  # item (row, b), row fastest: column b + j * q
            q = 1 << plan.logq
            items = np.arange(plan.rows * q)
            words = (tfk.t_cross_columns(plan, radices)[items >> plan.lr] * big_m
                     + (items & (plan.rows - 1))[:, None])
            for w in range(0, len(items), 32):
                for j in range(words.shape[1]):
                    assert _whole_segments(words[w:w + 32, j])


def _jax_operands(rng, p, m, n):
    """A row-FFT'd image stack and a PSF spectrum made by the revorder
    forward path, as the pipeline feeds them (numpy, JAX roll order)."""
    a = rng.standard_normal((p, m, n)).astype(np.float32)
    h = rng.random((m, n)).astype(np.float32) / (m * n) ** 0.5
    ar, ai = fft_rows_pallas(jnp.asarray(a), None, False, ordering="revorder", engine="roll")
    hr, hi = fft_rows_pallas(jnp.asarray(h), None, False, ordering="revorder", engine="roll")
    return [np.array(x) for x in (ar, ai, hr, hi)]


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= REL * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("mode", ["wiener", "conv", "conv_conj"])
@pytest.mark.parametrize("m,n", [(128, 256), (256, 128)])
def test_spectral_emulation_matches_jax_spectral_rows_t(rng, m, n, mode):
    """B2's plan against the JAX wiener_spectral_rows_t (interpret mode):
    'wiener', and 'conv' with H (conv) or a negated H_im (conv_conj)."""
    ar, ai, hr, hi = _jax_operands(rng, 2, m, n)
    if mode == "wiener":
        ref = wiener_spectral_rows_t((ar, ai), (hr, hi), K, engine="roll")
    else:
        ref = wiener_spectral_rows_t((ar, ai), (hr, -hi if mode == "conv_conj" else hi), 0.0,
                                     engine="roll", spectral_filter="conv")
    ours = emulate_spectral(*(torch.from_numpy(x) for x in (ar, ai, hr, hi)), mode)
    for o, r in zip(ours, ref):
        assert o.shape == (2, n, m)
        _close(o, r)


@pytest.mark.parametrize("p,m,n", [(3, 64, 256), (2, 128, 64)])
def test_spectral_emulation_matches_jax_fwd_wiener_rows(rng, p, m, n):
    """B7's plan against the JAX fwd_wiener_rows_pallas (interpret mode)."""
    ar, ai, hr, hi = _jax_operands(rng, p, m, n)
    ref = fwd_wiener_rows_pallas((jnp.asarray(ar), jnp.asarray(ai)), (hr, hi), K, engine="roll")
    ours = emulate_spectral(*(torch.from_numpy(x) for x in (ar, ai, hr, hi)), "b7")
    for o, r in zip(ours, ref):
        assert o.shape == (p, m, n)
        _close(o, r)


@pytest.mark.parametrize("n", POW2)
def test_spectral_rows_plan_conflicts_no_worse_than_b2(n):
    """B10's plan (the row store) hits no more threads a bank in any group,
    either pass, than B2's plan of the same length and rows a block: its
    pinned top DIT group and its DIT maps add no conflict. (Its rows come
    from the natural-store budget, 2 at n = 2048, where the padded rows
    leave one exchange 2 threads a bank in either plan; B2's own 8 rows
    are conflict-free there.)"""
    b10 = tfk.s_plan(n, (), 1 << 20, "rows")
    b2 = tfk.s_plan(n, (), 1 << 20, "transposed", 0, b10.rows, b10.threads)
    worst = [max(tfk.t_bank_conflicts(p, g) for g in p.groups + p.dit_groups) for p in (b10, b2)]
    assert worst[0] <= worst[1], worst


@pytest.mark.parametrize("p,m,n", [(3, 128, 128), (2, 100, 64)])
def test_spectral_emulation_matches_jax_spectral_rows(p, m, n):
    """B10's plan against the JAX wiener_spectral_rows_pallas (interpret
    mode) at the shapes of tests/test_torch_ops_kernels.py, 1e-5 of the
    output's max magnitude."""
    rng = np.random.default_rng(2)
    ar, ai = (rng.standard_normal((p, m, n)).astype(np.float32) for _ in range(2))
    hr, hi = (rng.standard_normal((m, n)).astype(np.float32) for _ in range(2))
    ref = wiener_spectral_rows_pallas((ar, ai), (hr, hi), K)
    ours = emulate_spectral(*(torch.from_numpy(x) for x in (ar, ai, hr, hi)), "b10")
    for o, r in zip(ours, ref):
        assert o.shape == (p, m, n)
        _close(o, r)
