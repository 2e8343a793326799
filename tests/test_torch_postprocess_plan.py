"""The white-balance kernels' launch plans and table, emulated on the CPU.

csrc/postprocess.cu's B4/B8a (`lab_l_partials_kernel`) and B5/B8b
(`wb_encode_kernel`) cut the frames into CUDA blocks after the wrapper's
plan (ops/kernels/postprocess.py `lab_l_plan`, `wb_encode_plan`); only
the card runs that index math, so these tests run it here: each block
decoded as the kernels decode it (`lab_l_cta`, `wb_encode_cta`), each
thread's 4-pixel groups of its rows as the kernels take them. B4's blocks
must take each pixel that the JAX package's `_block_geometry` samples
once and no other; B5's stores, 32-bit words where whole and aligned and
bytes elsewhere, must write each byte of the (B, h, w, 3) stack once.
The uint8 sRGB table's formula (`srgb_to_linear_u8`: true divisions,
precise powers), in plain torch, must equal the plain version's
conversion bit for bit. The partials summed block by block from the
plain L planes, then reduced in the wrapper's order, must match the JAX
kernels (interpret mode) to the 1e-5 relative of
tests/test_torch_postprocess.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import postprocess as jpp
from fft_restoration_tpu_torch.ops.color import _srgb_to_linear, luminance_l_planar
from fft_restoration_tpu_torch.ops.kernels import postprocess as tpp
from fft_restoration_tpu_torch.ops.kernels import u8_to_unit

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

# (B, plane extent, live extent, stride, block rows): strides 1 and 4,
# w % 4 in {0, 1, 2, 3}, ragged heights, B up to 64, narrow frames
LAB_CASES = [
    (1, (256, 256), (256, 256), 1, 64),
    (1, (256, 256), (200, 230), 1, 64),
    (2, (512, 256), (300, 201), 4, 8),
    (3, (256, 512), (257 - 57, 299), 4, 8),
    (5, (64, 64), (61, 62), 1, 64),
    (64, (32, 32), (29, 31), 1, 64),
    (2, (2048, 64), (2000, 63), 4, 8),
    (1, (384, 640), (330, 640), 1, 64),
    (1, (8, 4), (5, 3), 1, 64),
]


def _sampled_mask(b, h0, w0, live, stride, block):
    """The pixels the JAX package's block geometry samples, per image."""
    h, w = live
    rows, hp, _ = jpp._block_geometry(h0, w0, block)
    mask = np.zeros((b, h, w), bool)
    for j in range(0, hp // rows, stride):
        mask[:, j * rows: min(h, j * rows + rows)] = True
    return mask


def _thread_groups(tx_log2, r0, r1, c0, w):
    """The (row, first column, live pixels) groups a block's threads take,
    as the kernels' loops do: thread (tx, ty) takes columns c0 + 4 tx of
    rows r0 + ty, r0 + ty + TY, ..."""
    tx_n, ty_n = 1 << tx_log2, tpp.THREADS >> tx_log2
    for ty in range(ty_n):
        for tx in range(tx_n):
            col = c0 + 4 * tx
            live = min(4, w - col)
            if live <= 0:
                continue
            for r in range(r0 + ty, r1, ty_n):
                yield r, col, live


@pytest.mark.parametrize("b,ext,live,stride,block", LAB_CASES)
def test_lab_plan_visits_each_sampled_pixel_once(b, ext, live, stride, block):
    plan = tpp.lab_l_plan(b, *ext, live, stride, block)
    h, w = live
    seen = np.zeros((b, h, w), np.int32)
    slots = np.zeros((b, plan.n_blocks, plan.n_slabs * plan.n_chunks), np.int32)
    for k in range(plan.n_ctas):
        img, blk, r0, r1, c0, c1 = tpp.lab_l_cta(plan, k)
        slots[img, blk, k % (plan.n_slabs * plan.n_chunks)] += 1
        assert blk * stride * plan.rows <= r0 and r1 <= blk * stride * plan.rows + plan.rows
        for r, col, n in _thread_groups(plan.tx_log2, r0, r1, c0, w):
            assert c0 <= col and col + n <= c1
            seen[img, r, col:col + n] += 1
    assert np.all(slots == 1)
    mask = _sampled_mask(b, *ext, live, stride, block)
    assert np.array_equal(seen, mask.astype(np.int32))
    assert seen.sum() == b * jpp.sampled_live_pixels(*ext, live, block, stride)


@pytest.mark.parametrize("b,hw,rows_a_thread", [(64, (1024, 1024), 1), (16, (2048, 2048), 1),
                                                (64, (2048, 2048), tpp.ROWS_A_THREAD)])
def test_plans_past_65535_blocks(b, hw, rows_a_thread):
    """Launches past 65535 blocks (a 1D grid; image offsets 64-bit in the
    kernels): every block decodes to a distinct region, and the regions'
    areas add up to the frames."""
    h, w = hw
    lab = tpp.lab_l_plan(b, h, w, hw, 1, 64, rows_a_thread)
    enc = tpp.wb_encode_plan(b, hw, rows_a_thread)
    assert max(lab.n_ctas, enc.n_ctas) > 65535
    for plan, cta in ((lab, tpp.lab_l_cta), (enc, tpp.wb_encode_cta)):
        regions = [cta(plan, k) for k in range(plan.n_ctas)]
        assert len(set(regions)) == plan.n_ctas
        area = sum((r[-3] - r[-4]) * (r[-1] - r[-2]) for r in regions)
        assert area == b * h * w
        assert regions[-1][0] == b - 1


# (B, live extent): w % 4 in {0, 1, 2, 3}, ragged heights, B up to 64
ENC_CASES = [(1, (16, 16)), (1, (150, 202)), (3, (37, 61)), (2, (9, 1023)), (64, (11, 13)),
             (1, (2, 1)), (4, (40, 640))]


@pytest.mark.parametrize("b,live", ENC_CASES)
def test_encode_store_map_covers_each_byte_once(b, live):
    h, w = live
    plan = tpp.wb_encode_plan(b, live)
    seen = np.zeros(b * h * w * 3, np.int32)
    word_stores = byte_stores = 0
    for k in range(plan.n_ctas):
        img, r0, r1, c0, c1 = tpp.wb_encode_cta(plan, k)
        for r, col, n in _thread_groups(plan.tx_log2, r0, r1, c0, w):
            assert col + n <= c1
            e = ((img * h + r) * w + col) * 3
            if n == 4 and e % 4 == 0:  # three aligned 32-bit words
                seen[e:e + 12] += 1
                word_stores += 3
            else:
                for j in range(n):
                    seen[e + 3 * j: e + 3 * j + 3] += 1
                byte_stores += 3 * n
    assert np.all(seen == 1)
    if w % 4 == 0:
        assert byte_stores == 0 and word_stores == 3 * b * h * w // 4


@pytest.mark.parametrize("w,tx_log2", [(1, 5), (128, 5), (256, 6), (640, 5), (1024, 8),
                                       (1920, 5), (2048, 8), (3840, 6), (4096, 8), (202, 6)])
def test_columns_fill_the_block_rows(w, tx_log2):
    """TX, the groups a block row takes: the fewest idle threads, then the
    widest row."""
    assert tpp.columns_log2(w) == tx_log2


def _srgb_u8_table():
    """csrc/postprocess.cu's srgb_to_linear_u8 in plain torch: each of the
    256 values divided by 255, then the formula with true divisions and
    precise powers."""
    x = torch.arange(256, dtype=torch.float32) / torch.full((), 255.0)
    t = torch.clamp((x + 0.055) / torch.full((), 1.055), min=1e-30)
    return torch.where(x <= 0.04045, x / torch.full((), 12.92), torch.exp2(torch.log2(t) * 2.4))


def test_srgb_u8_table_twin_is_the_plain_conversion():
    v = torch.arange(256, dtype=torch.uint8)
    plain = _srgb_to_linear(torch.clamp(u8_to_unit(v), 0.0, 1.0))
    twin = _srgb_u8_table()
    assert twin.dtype == torch.float32 and torch.equal(twin, plain)


def _raw_and_norm(rng, c, hp, wp):
    raw = (rng.standard_normal((c, hp, wp)) * 40.0 + 7.0).astype(np.float32)
    lo = raw.min(axis=(1, 2))
    hi = raw.max(axis=(1, 2))
    return raw, lo, (1.0 / (hi - lo)).astype(np.float32)


@pytest.mark.parametrize("b,ext,live,stride,block", [
    (1, (256, 256), (200, 230), 1, 64),
    (1, (512, 256), (300, 201), 4, 8),
    (3, (128, 128), (120, 127), 1, 64),
    (2, (256, 128), (250, 125), 4, 8),
])
def test_lab_partition_emulation_matches_jax(rng, b, ext, live, stride, block):
    """Each CUDA block's region of the plain L planes summed, then each
    row block's slabs and chunks summed in the wrapper's order, against
    the JAX kernel's partials."""
    h, w = live
    raw, lo, scale = _raw_and_norm(rng, 3 * b + 1, *ext)
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    orig = np.moveaxis(frames, -1, 1)  # (B, 3, h, w)
    plan = tpp.lab_l_plan(b, *ext, live, stride, block)
    nb = ((torch.from_numpy(raw[: 3 * b]) - torch.from_numpy(lo[: 3 * b, None, None]))
          * torch.from_numpy(scale[: 3 * b, None, None]))[:, :h, :w].reshape(b, 3, h, w)
    o = u8_to_unit(torch.from_numpy(np.ascontiguousarray(orig)))
    planes = [luminance_l_planar(x[:, 0], x[:, 1], x[:, 2]) for x in (nb, o)]
    parts = torch.zeros((b, plan.n_blocks, plan.n_slabs * plan.n_chunks, 2))
    for k in range(plan.n_ctas):
        img, blk, r0, r1, c0, c1 = tpp.lab_l_cta(plan, k)
        for q, lp in enumerate(planes):
            parts[img, blk, k % (plan.n_slabs * plan.n_chunks), q] = lp[img, r0:r1, c0:c1].sum()
    ours = parts.sum(dim=2).numpy()
    if b == 1:
        ref = np.asarray(jpp.lab_l_sum_partials(
            jnp.asarray(raw), jnp.asarray(orig[0]), norm=(lo[:3], scale[:3]), live_hw=live,
            stride=stride, block_rows=block))[None, :, :2]
    else:
        ref = np.asarray(jpp.lab_l_sum_partials_batched(
            jnp.asarray(raw), jnp.asarray(orig.reshape(3 * b, h, w)), b,
            norm=(lo[: 3 * b], scale[: 3 * b]), live_hw=live, stride=stride,
            block_rows=block))[..., :2]
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
