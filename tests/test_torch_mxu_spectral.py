"""B2's and B7's MXU group DFT (csrc/fft_group_dft_smem.cuh group_dft_sym,
in csrc/wiener_spectral.cu spectral_s_mxu_kernel), checked on the CPU: one
64 KB table for both directions at each precision, read back through the
fragment layouts the kernels assume, against the plain version's operands
of either direction (and the JAX package's planes); the four-product
combine over those tables against the three-product twin group_dft_plain
and the JAX group product in both directions; the warp tasks' cover of
every bin; the plans' rows beside the resident table, and the route of B7
at 'default', which keeps the L2 design.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import fft_kernel as jfk
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

BINS = 16 * tfk.DFT_HALF_TILES  # columns 0 .. 63 of the DFT matrix


def _decode(frags, precision):
    """(tables, BINS, 128) float32 A[bin][pos] of a B2/B7 table in the
    kernels' fragment order, every element written once."""
    row, col = tfk.dft_fragment_index(precision)
    row, col = row[:tfk.DFT_HALF_TILES], col[:tfk.DFT_HALF_TILES]
    if frags.dtype == np.uint16:  # bf16 bit patterns
        frags = (frags.astype(np.uint32) << 16).view(np.float32)
    tables = frags.shape[2]
    out = np.full((tables, BINS, 128), np.nan, np.float32)
    for t in range(tables):
        v = frags[:, :, t]
        r, c = np.broadcast_to(row, v.shape), np.broadcast_to(col, v.shape)
        count = np.zeros((BINS, 128), np.int64)
        np.add.at(count, (r, c), 1)
        assert (count == 1).all()
        out[t][r, c] = v
    return out


def _sym_tables(precision):
    """The kernels' c, s, c + s, c - s (BINS, 128) of a precision: the bf16
    values of the 'default' table; at 'highest' the float32 c, s with their
    float32 sum and difference (summed as the kernel sums them)."""
    if precision == "default":
        return tuple(_decode(tfk.dft_half_default_fragments_np(), "default"))
    c, s = _decode(tfk.dft_half_tables("highest", torch.device("cpu")).numpy(), "highest")
    return c, s, c + s, c - s


def test_table_sizes():
    """Both precisions' tables are DFT_HALF_BYTES (64 KB): a resident copy
    a block beside the plans' rows."""
    assert tfk.DFT_HALF_BYTES == 64 * 1024
    assert tfk.dft_half_default_fragments_np().nbytes == tfk.DFT_HALF_BYTES
    for precision in tfk.MXU_PRECISIONS:
        t = tfk.dft_half_tables(precision, torch.device("cpu"))
        assert t.numel() * t.element_size() == tfk.DFT_HALF_BYTES


@pytest.mark.parametrize("inverse", [False, True])
def test_default_table_decodes_to_the_plain_operands(inverse):
    """The 'default' table's c, s, c + s, c - s are the plain version's bf16
    Wc, Ws and Wc + Ws of either direction over bins 0 .. 63, bit for bit
    (the inverse direction's Ws is -s, its Wc + Ws is c - s); at the mirror
    bins 128 - k, k = 1 .. 63, they are (c, -s, c - s) of the forward
    direction and (c, s, c + s) of the inverse one up to the float64 zeros'
    last bits (1e-13)."""
    c, s, cps, cms = _sym_tables("default")
    wc, ws, wcs = (w.numpy().T for w in tfk._dft_operands(inverse, "default",
                                                         torch.device("cpu")))
    sign = -1.0 if inverse else 1.0
    assert np.array_equal(c, wc[:BINS])
    assert np.array_equal(sign * s, ws[:BINS])
    assert np.array_equal(cms if inverse else cps, wcs[:BINS])
    k = np.arange(1, 64)
    assert np.abs(wc[128 - k] - c[k]).max() <= 1e-13
    assert np.abs(ws[128 - k] + sign * s[k]).max() <= 1e-13
    assert np.abs(wcs[128 - k] - (cps if inverse else cms)[k]).max() <= 1e-13
    # the JAX package's planes, rounded as the plain version rounds them
    jc, js = (np.asarray(w).T for w in jfk._dft_planes_np(128, inverse))
    bf = tfk._bf16
    assert np.array_equal(c, bf(torch.from_numpy(jc[:BINS].copy())).numpy())
    assert np.array_equal(sign * s, bf(torch.from_numpy(js[:BINS].copy())).numpy())


@pytest.mark.parametrize("inverse", [False, True])
def test_highest_table_serves_both_directions(inverse):
    """The 'highest' table is the first 4 bin tiles of the row kernels'
    forward symmetric tables (dft_sym_fragments_np(False)); the inverse
    direction's are its c and its negated s, bit for bit, so one copy
    serves both."""
    fwd = tfk.dft_sym_fragments_np(False)[:tfk.DFT_HALF_TILES]
    assert np.array_equal(tfk.dft_half_tables("highest", torch.device("cpu")).numpy(), fwd)
    other = tfk.dft_sym_fragments_np(inverse)[:tfk.DFT_HALF_TILES]
    assert np.array_equal(other[:, :, 0], fwd[:, :, 0])
    assert np.array_equal(other[:, :, 1], (-1.0 if inverse else 1.0) * fwd[:, :, 1])


def _four_product_dft(x_re, x_im, inverse, precision):
    """The kernels' symmetric group DFT from their own table, in float32
    (the card accumulates its products in float32): per bin tile the
    products m1 = xr c, m2 = xi s, m3 = xs (c + s), m4 = xs (c - s) over
    columns 0 .. 63 (xs = xr + xi; xr, xi and xs rounded to bf16 at
    'default' as the kernel packs them), each bin written as
    csrc/fft_group_dft_smem.cuh sym_results writes it: P = (m1 - m2, m3 -
    m1 - m2), Q = (m1 + m2, m4 - m1 + m2), bin k <- P and 128 - k <- Q in
    the forward direction, swapped in the inverse one; bin 64 as sym_bin64
    writes it, from the sums m1 = sum (-1)^l xr_l and m3 = sum (-1)^l xs_l:
    (m1, m3 - m1) in either direction."""
    from fft_restoration_tpu_torch.ops.fft import _full_float32

    c, s, cps, cms = (torch.from_numpy(t.T.copy()) for t in _sym_tables(precision))
    xr = torch.from_numpy(x_re.reshape(-1, 128))
    xi = torch.from_numpy(x_im.reshape(-1, 128))
    xs = xr + xi
    if precision == "default":
        xr, xi, xs = tfk._bf16(xr), tfk._bf16(xi), tfk._bf16(xs)
    sign = torch.ones(128, 1)
    sign[1::2] = -1.0
    with _full_float32(xr):
        m1, m2, m3, m4, b1, b3 = (v.numpy() for v in (xr @ c, xi @ s, xs @ cps, xs @ cms,
                                                      xr @ sign, xs @ sign))
    p = (m1 - m2, m3 - m1 - m2)
    q = (m1 + m2, m4 - m1 + m2)
    if inverse:
        p, q = q, p
    yr = np.full(xr.shape, np.nan)
    yi = np.full(xr.shape, np.nan)
    for mt in range(tfk.DFT_HALF_TILES):
        for k in range(16 * mt, 16 * mt + 16):
            yr[:, k], yi[:, k] = p[0][:, k], p[1][:, k]
            if k > 0:
                yr[:, 128 - k], yi[:, 128 - k] = q[0][:, k], q[1][:, k]
    yr[:, 64], yi[:, 64] = b1[:, 0], b3[:, 0] - b1[:, 0]
    return yr.reshape(x_re.shape), yi.reshape(x_re.shape)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_product_combine_matches_the_twin(precision, inverse):
    """The four-product combine over the B2/B7 table gives every bin (none
    left NaN) of both directions within 1e-6 of the plane's max of the
    three-product twin group_dft_plain at the same precision, and at
    'highest' of the JAX package's group product too. On a DC-heavy
    spectrum (the twin's float32 rounding sets its small values) the same
    within 2e-6: bin 64's sums, in another order than the twin's product,
    round apart by up to ~1.1e-6 of the max there, the twin's own float32
    error."""
    rng = np.random.default_rng(23 + 2 * inverse + (precision == "highest"))
    x = rng.standard_normal((6, 256)).astype(np.float32)
    y = rng.standard_normal((6, 256)).astype(np.float32)
    dc_x, dc_y = x.copy(), y.copy()
    dc_x[:, ::128] += 5e3
    dc_y[:, ::128] -= 3e3
    for a, b, tol in ((x, y, 1e-6), (dc_x, dc_y, 2e-6)):
        yr, yi = _four_product_dft(a, b, inverse, precision)
        assert not np.isnan(yr).any() and not np.isnan(yi).any()
        tr, ti = tfk.group_dft_plain(torch.from_numpy(a), torch.from_numpy(b), inverse, precision)
        refs = [(tr.numpy(), ti.numpy())]
        if precision == "highest":
            jr, ji = jfk._group_dft_matmul(jnp.asarray(a), jnp.asarray(b),
                                           *(jnp.asarray(w) for w in jfk._dft_planes_np(128,
                                                                                        inverse)))
            refs.append((np.asarray(jr), np.asarray(ji)))
        for ref_r, ref_i in refs:
            for ours, ref in ((yr, ref_r), (yi, ref_i)):
                assert np.abs(ours - ref).max() <= tol * np.abs(ref).max()


def test_tasks_write_every_bin_once_in_both_directions():
    """A task's 4 bin tiles write bins 0 .. 63 and the mirrors 128 - k of
    1 .. 63 of each of its groups, bin 64 comes from the sums: each of the
    128 bins once, in either direction (the swap moves P and Q between a bin
    and its mirror, not the bins)."""
    bins = [64]
    for mt in range(tfk.DFT_HALF_TILES):
        cols = range(16 * mt, 16 * mt + 16)
        bins += [k for k in cols] + [128 - k for k in cols if k > 0]
    assert sorted(bins) == list(range(128))


def _mxu_lengths():
    """Every (n, radices) the B2/B7 kernels take at mxu: pow2 n = 128 ..
    MAX_KERNEL_N and n = R * q for each kernel radix tuple, q >= 128."""
    out = [(1 << e, ()) for e in range(tfk.MXU_LOG, tfk.MAX_KERNEL_N.bit_length())]
    for radices in tfk.KERNEL_RADIX_TUPLES:
        r = int(np.prod(radices))
        q = tfk.MXU_INNER
        while r * q <= tfk.MAX_KERNEL_N:
            out.append((r * q, radices))
            q *= 2
    return out


@pytest.mark.parametrize("store", ["transposed", "natural"])
@pytest.mark.parametrize("n,radices", _mxu_lengths())
def test_plans_fit_beside_the_table(store, n, radices):
    """For every length s_plan(mxu=True) takes, B2's and B7's rows, the
    64 KB table and the mbarrier's slot fit a block's shared memory, at any
    plane height (ragged ones too); the threads are a multiple of 32 up to
    512, every thread's 16 slots live; the groups run the outer stages
    7 .. S - 1."""
    stages = tfk.check_length(n, radices)
    for m in (1, 5, 37, 256, 2048, 1 << 20):
        plan = tfk.s_plan(n, radices, m, store, 264, mxu=True)
        assert plan.smem_bytes + tfk.DFT_HALF_BYTES + tfk.DFT_RES_BAR <= tfk.MAX_BLOCK_SMEM
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= tfk.T_THREADS
        assert plan.rows * n >= tfk.T_SLOTS and plan.rows & (plan.rows - 1) == 0
        covered = sorted(s for s_lo, k, *_ in plan.groups for s in range(s_lo, s_lo + k))
        assert covered == list(range(tfk.MXU_LOG, stages))
        if store == "transposed" and not plan.direct_store:
            assert tfk._t_store_conflicts(plan) <= 1


def test_headline_geometry():
    """B2 at the headline's 2048 points and the UHD frame's 2304: 8 rows (the
    transposed store's 32-byte column segments), 16 and 18 warp tasks a
    row block; 4 rows of 3840, where 8 do not fit beside the table; B7 at
    batch64's 256 points: 64 rows, 16 tasks."""
    b2 = tfk.s_plan(2048, (), 2048, "transposed", 132, mxu=True)
    assert (b2.rows, b2.threads, b2.rows * 2048 // 128 // tfk.DFT_TASK) == (8, 512, 16)
    assert tfk.s_plan(2304, (3, 3), 2048, "transposed", 132, mxu=True).rows == 8
    assert tfk.s_plan(3840, (3, 5), 2048, "transposed", 132, mxu=True).rows == 4
    b7 = tfk.s_plan(256, (), 256, "natural", mxu=True)
    assert (b7.rows, b7.threads, b7.rows * 256 // 128 // tfk.DFT_TASK) == (64, 512, 16)


@pytest.mark.parametrize("n,radices", [(128, ()), (256, ()), (384, (3,)), (640, (5,)), (2048, ())])
def test_b7_default_keeps_pr20s_route(n, radices):
    """Every B2 launch and B7's at 'highest' keep the half table resident;
    B7 at 'default' runs the L2 design (csrc/wiener_spectral.cu
    spectral_s_l2_kernel): roll's rows and threads with the outer-stage
    groups, and the L2 design's forward fragment tables (96 KB) as its table."""
    assert [tfk.spectral_resident(st, c) for st in ("transposed", "natural")
            for c in (0, 1, 2)] == [False, True, True, False, False, True]
    cpu = torch.device("cpu")
    assert tfk.spectral_table_pointer("natural", 0, cpu) == 0
    assert (tfk.spectral_table_pointer("natural", 1, cpu)
            == tfk.dft_fragments(False, "default", cpu).data_ptr())
    for store, code in (("transposed", 1), ("transposed", 2), ("natural", 2)):
        assert (tfk.spectral_table_pointer(store, code, cpu)
                == tfk.dft_half_tables(tfk.MXU_PRECISIONS[code - 1], cpu).data_ptr())
    for m in (37, 256, 330, 1 << 20):
        l2 = tfk.s_plan(n, radices, m, "natural", mxu=True, resident=False)
        roll = tfk.s_plan(n, radices, m, "natural")
        assert (l2.rows, l2.threads) == (roll.rows, roll.threads)
        assert l2.groups == tfk.s_plan(n, radices, m, "natural", mxu=True).groups
    assert tfk.s_plan(256, (), 256, "natural", mxu=True, resident=False).rows == 16
