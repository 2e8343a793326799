"""The MXU row kernels' group DFT with resident tables
(csrc/fft_group_dft_smem.cuh, in B1's fft_rows_t_mxu_kernel and B3/B6's
fft_rows_mxu_kernel), checked on the CPU: the plans' shared memory beside
the tables, the warp tasks' cover of every group and bin, the symmetric
'highest' tables against the float64-built DFT planes bit for bit, and
the symmetric form (the three-product form at bin k and at its mirror)
against the three-product twin and the JAX package's group product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import fft_kernel as jfk
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

# (n, radices) of the passes the pipelines give the MXU engine: pow2 from
# q = 128 up to the longest kernel row, and smooth extents whose pow2
# tail is 128 or 256 (the UHD frame's 2304 and 3840, 640x330's 384 x 640)
SHAPES = [(128, ()), (256, ()), (2048, ()), (4096, ()), (16384, ()), (384, (3,)), (640, (5,)),
          (2304, (3, 3)), (3840, (3, 5))]


def _mxu_plans(n, radices, m=2048):
    """B1 forward and inverse, B3 (packed), B6 (natural store) at mxu."""
    return {
        "B1": tfk.t_plan(n, radices, m, False, 264, mxu=True),
        "B1_inv": tfk.t_plan(n, radices, m, True, 264, mxu=True),
        "B3": tfk.r_plan(n, radices, m, True, packed=True, mxu=True),
        "B6": tfk.r_plan(n, radices, m, False, mxu=True),
    }


@pytest.mark.parametrize("n,radices", SHAPES)
def test_resident_plans_fit_beside_their_tables(n, radices):
    """Every mxu plan's rows and the direction's resident table chunks fit a
    block's shared memory: all of the tables at 'highest', and at
    'default' all but beside 8 rows of 2048 points, 4 of 4096 (B1's
    32-byte store segments) and one row of 16384, where 62 of the 64
    chunks are resident (the kernels read the last two from global
    memory); the threads are a multiple of 32 up to 512; the groups run
    the outer stages 7 .. S - 1."""
    stages = tfk.check_length(n, radices)
    for name, plan in _mxu_plans(n, radices).items():
        for precision in tfk.MXU_PRECISIONS:
            chunks = tfk.dft_res_chunks(precision, plan.smem_bytes)
            total = (chunks * tfk.DFT_RES_CHUNK_BYTES[precision] + tfk.DFT_RES_BAR
                     + plan.smem_bytes + 1024)
            assert total <= tfk.MAX_BLOCK_SMEM, (name, precision)
            full = tfk.DFT_RES_CHUNKS[precision]
            assert chunks == full or (precision == "default" and n in (2048, 4096, 16384)
                                      and chunks == 62), (name, precision, chunks)
        assert plan.threads % 32 == 0 and plan.threads <= tfk.MXU_THREADS, name
        covered = sorted(s for s_lo, k, *_ in plan.groups for s in range(s_lo, s_lo + k))
        assert covered == list(range(tfk.MXU_LOG, stages)), name
    # B3's block holds whole min/max partials, and at a pow2 n up to 2048
    # 64 groups or more (16 warp tasks): 2 partials a block at n = 256
    b3, part = _mxu_plans(n, radices)["B3"], tfk.rows_per_block(n, 2048)
    assert b3.rows % part == 0
    if not radices and n <= 2048:
        assert b3.rows * n >= tfk.MXU_TASK_GROUPS * tfk.MXU_INNER, (n, b3.rows)
    # the headline frame's B1 and B6 passes: 8 rows of 2048 beside 62 of
    # the 64 'default' chunks (all at 'highest'), B3's 4 of one partial
    # beside all of them
    if n == 2048:
        plans = _mxu_plans(n, radices)
        assert [plans[k].rows for k in ("B1", "B1_inv", "B3", "B6")] == [8, 8, 4, 8]
        assert {p.threads for p in plans.values()} == {512}
        assert [tfk.dft_res_chunks("default", plans[k].smem_bytes)
                for k in ("B1", "B1_inv", "B3", "B6")] == [62, 62, 64, 62]


@pytest.mark.parametrize("code", [0, 1, 2])
@pytest.mark.parametrize("n,radices", SHAPES)
def test_launch_chunks_are_the_plans(code, n, radices):
    """The chunk count each launch passes to the kernel (res_chunks): none
    at roll and on the forward passes at 'default' (the L2 design's
    kernels), else
    the chunks that fit beside the plan's rows, every one of them at
    'highest', within the block's shared memory with the mbarrier's slot
    and the static scratch."""
    inverse = {"B1": False, "B1_inv": True, "B3": True, "B6": False}
    for name, plan in _mxu_plans(n, radices).items():
        chunks = tfk.res_chunks(code, plan, inverse[name])
        if not code or (code == 1 and not inverse[name]):
            assert chunks == 0
            continue
        precision = tfk.MXU_PRECISIONS[code - 1]
        assert chunks == tfk.dft_res_chunks(precision, plan.smem_bytes), name
        assert 0 < chunks <= tfk.DFT_RES_CHUNKS[precision], name
        if precision == "highest":
            assert chunks == tfk.DFT_RES_CHUNKS[precision], name
        smem = chunks * tfk.DFT_RES_CHUNK_BYTES[precision] + tfk.DFT_RES_BAR + plan.smem_bytes
        assert smem + 1024 <= tfk.MAX_BLOCK_SMEM, name


def _cover(groups, warps, precision):
    """(groups, 128) counts of the bins the warp tasks write."""
    hits = np.zeros((groups, 128), np.int64)
    for firsts in tfk.group_dft_res_tasks(groups, warps).values():
        for first in firsts:
            for g in range(first, min(first + tfk.DFT_TASK, groups)):
                for mt in range(8 if precision == "default" else tfk.DFT_SYM_TILES):
                    hits[g, list(tfk.group_dft_res_bins(precision, mt))] += 1
    return hits


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("n,radices", SHAPES)
def test_tasks_cover_every_group_and_bin_once(precision, n, radices):
    """The warp tasks of every mxu plan's block write each bin of each of
    its groups once: the plans' own blocks (rows x n / 128 groups), a
    ragged last block (the plane height not a multiple of the rows: the
    kernel transforms the block's zero rows too) and blocks whose live rows
    end inside them; group counts that are not a multiple of the task
    width (q = 256 smooth extents: 30 groups a row at 3840)."""
    for name, plan in _mxu_plans(n, radices).items():
        groups = plan.rows * n // tfk.MXU_INNER
        assert (_cover(groups, plan.threads // 32, precision) == 1).all(), (name, groups)
    for groups, warps in ((1, 2), (7, 2), (13, 4), (30, 16), (60, 16), (120, 16), (9, 6)):
        assert (_cover(groups, warps, precision) == 1).all(), (groups, warps)


@pytest.mark.parametrize("m,live_rows", [(2048, 2048), (2048, 50), (37, 37), (1000, 999)])
def test_persistent_walk_visits_every_row_block_once(m, live_rows):
    """The persistent blocks' walk (block b takes row blocks b, b + grid,
    ...) visits each of a launch's row blocks once; those past the live
    rows are the zero blocks, the others transform all their rows."""
    plan = tfk.t_plan(2048, (), m, False, 264, mxu=True)
    pairs, rows = 2, plan.rows
    nblk = -(-m // rows)
    blocks = nblk * pairs
    for grid in (1, 7, 132, blocks):
        seen = [rb for b in range(min(grid, blocks)) for rb in range(b, blocks, grid)]
        assert sorted(seen) == list(range(blocks))
    live = [rb for rb in range(blocks) if (rb % nblk) * rows < live_rows]
    assert len(live) == pairs * -(-live_rows // rows)


@pytest.mark.parametrize("inverse", [False, True])
def test_symmetric_tables_are_the_float64_columns(inverse):
    """The 'highest' resident tables (dft_sym_fragments_np), read back
    through the m16n8k8 layout csrc/fft_group_dft_smem.cuh assumes, are
    columns 0 .. 79 of the float64-built _dft_planes_np(128) planes, bit
    for bit, every element once; they are the JAX package's planes too."""
    frags = tfk.dft_sym_fragments_np(inverse)
    assert frags.dtype == np.float32 and frags.nbytes == tfk.DFT_RES_BYTES["highest"]
    row, col = tfk.dft_fragment_index("highest")
    row, col = row[:tfk.DFT_SYM_TILES], col[:tfk.DFT_SYM_TILES]
    bins = 16 * tfk.DFT_SYM_TILES
    for t, w in enumerate(jfk._dft_planes_np(128, inverse)):
        a = np.full((bins, 128), np.nan, np.float32)
        count = np.zeros((bins, 128), np.int64)
        v = frags[:, :, t]
        r, c = np.broadcast_to(row, v.shape), np.broadcast_to(col, v.shape)
        a[r, c] = v
        np.add.at(count, (r, c), 1)
        assert (count == 1).all()
        for k in range(bins):  # column by column
            assert np.array_equal(a[k], np.asarray(w)[:, k]), (t, k)


@pytest.mark.parametrize("inverse", [False, True])
def test_default_resident_tables_are_the_fragment_tables(inverse):
    """'default' keeps group_dft's bf16 fragment tables (96 KB)."""
    res = tfk.dft_res_tables(inverse, "default", torch.device("cpu"))
    assert res.numel() * res.element_size() == tfk.DFT_RES_BYTES["default"]
    assert np.array_equal(res.numpy().view(np.uint16), tfk.dft_fragments_np(inverse, "default"))
    sym = tfk.dft_res_tables(inverse, "highest", torch.device("cpu"))
    assert np.array_equal(sym.numpy(), tfk.dft_sym_fragments_np(inverse))


def _sym_group_dft(x_re, x_im, inverse):
    """The kernel's 'highest' form in float64 from its own tables: per bin
    tile the products m1 = xr c, m2 = xi s, m3 = xs (c + s), m4 = xs (c -
    s) over columns 0 .. 79 (xs = xr + xi, c + s and c - s summed in
    float32 as the kernel sums them), each bin written as
    group_dft_res_bins names it: (m1 - m2, m3 - m1 - m2) at bin k and (m1
    + m2, m4 - m1 + m2) at its mirror 128 - k."""
    frags = tfk.dft_sym_fragments_np(inverse)
    row, col = tfk.dft_fragment_index("highest")
    row, col = row[:tfk.DFT_SYM_TILES], col[:tfk.DFT_SYM_TILES]
    bins = 16 * tfk.DFT_SYM_TILES
    c = np.zeros((bins, 128), np.float32)
    s = np.zeros((bins, 128), np.float32)
    shape = frags[:, :, 0].shape
    c[np.broadcast_to(row, shape), np.broadcast_to(col, shape)] = frags[:, :, 0]
    s[np.broadcast_to(row, shape), np.broadcast_to(col, shape)] = frags[:, :, 1]
    xr = x_re.reshape(-1, 128)
    xi = x_im.reshape(-1, 128)
    xs = (xr + xi).astype(np.float64)
    xr, xi = xr.astype(np.float64), xi.astype(np.float64)
    m1, m2 = xr @ c.T.astype(np.float64), xi @ s.T.astype(np.float64)
    m3, m4 = xs @ (c + s).T.astype(np.float64), xs @ (c - s).T.astype(np.float64)
    yr = np.full(xr.shape, np.nan)
    yi = np.full(xr.shape, np.nan)
    for mt in range(tfk.DFT_SYM_TILES):
        for k in range(16 * mt, 16 * mt + 16):
            if k <= 64:
                yr[:, k], yi[:, k] = m1[:, k] - m2[:, k], m3[:, k] - m1[:, k] - m2[:, k]
            if 0 < k < 64:
                yr[:, 128 - k] = m1[:, k] + m2[:, k]
                yi[:, 128 - k] = m4[:, k] - m1[:, k] + m2[:, k]
    assert sorted(b for mt in range(tfk.DFT_SYM_TILES)
                  for b in tfk.group_dft_res_bins("highest", mt)) == list(range(128))
    return yr.reshape(x_re.shape), yi.reshape(x_re.shape)


@pytest.mark.parametrize("inverse", [False, True])
def test_symmetric_form_matches_the_twin_and_jax(inverse):
    """The symmetric form gives every bin (none left NaN) within 2e-6 of
    the plane's max of the three-product float32 twin group_dft_plain
    ('highest', the card's twin) and of the JAX package's group product:
    the mirror columns differ from the twin's by at most an ulp."""
    rng = np.random.default_rng(11 + inverse)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    y = rng.standard_normal((6, 256)).astype(np.float32)
    yr, yi = _sym_group_dft(x, y, inverse)
    assert not np.isnan(yr).any() and not np.isnan(yi).any()
    tr, ti = tfk.group_dft_plain(torch.from_numpy(x), torch.from_numpy(y), inverse, "highest")
    jr, ji = jfk._group_dft_matmul(jnp.asarray(x), jnp.asarray(y),
                                   *(jnp.asarray(w) for w in jfk._dft_planes_np(128, inverse)))
    for ours, refs in ((yr, (tr.numpy(), np.asarray(jr))), (yi, (ti.numpy(), np.asarray(ji)))):
        for ref in refs:
            scale = np.abs(ref).max()
            assert np.abs(ours - ref).max() <= 2e-6 * scale
    # the mirror columns' tables: within an ulp of the direct columns
    wc, ws = tfk._dft_planes_np(128, inverse)
    k = np.arange(1, 64)
    assert np.abs(wc[:, 128 - k] - wc[:, k]).max() <= np.finfo(np.float32).eps
    assert np.abs(ws[:, 128 - k] + ws[:, k]).max() <= np.finfo(np.float32).eps


@pytest.mark.parametrize("n,radices", SHAPES)
def test_forward_default_passes_keep_l2_plans(n, radices):
    """The forward B1 and B6 passes at 'default' run the L2 design's kernels
    (resident_route false): their plans take roll's rows and threads (B1:
    T_SMEM_BUDGET and the halving for small launches; B6: R_SMEM_BUDGET
    and R_PLAN_THREADS) with the mxu engine's outer-stage groups, and their
    launches pass no table chunks; every other tensor-core pass takes the
    resident route."""
    assert [tfk.resident_route(c, inv) for c in (0, 1, 2) for inv in (False, True)] == [
        False, False, False, True, True, True]
    for m, wanted in ((2048, 264), (330, 132), (256, 3)):
        b1 = tfk.t_plan(n, radices, m, False, wanted, mxu=True, resident=False)
        roll = tfk.t_plan(n, radices, m, False, wanted)
        assert (b1.rows, b1.threads) == (roll.rows, roll.threads), (m, wanted)
        assert b1.groups == tfk.t_plan(n, radices, m, False, wanted, mxu=True).groups
        assert not b1.direct_store and tfk.res_chunks(1, b1, False) == 0
        b6 = tfk.r_plan(n, radices, m, False, mxu=True, resident=False)
        roll = tfk.r_plan(n, radices, m, False)
        assert (b6.rows, b6.threads) == (roll.rows, roll.threads), m
        assert b6.threads <= tfk.R_THREADS and tfk.res_chunks(1, b6, False) == 0
