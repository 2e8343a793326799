"""White-balance post-processing (B4/B5, B8a/B8b) — wrappers, plain
versions, the block geometry that decides which pixels feed the gain,
and the kernels' launch plans.

Counterpart of fft_restoration_tpu/ops/pallas/postprocess.py:
  B8a `lab_l_sum_partials_batched` (B4 `lab_l_sum_partials` is its B = 1
     case): in one pass over the raw restored planes and the original
     frames, the fused per-plane min-max normalize and the Lab-L block
     sums of both (each image's white-balance gain's two means);
  B8b `wb_encode_u8_batched` (B5 `wb_encode_u8` is its B = 1 case):
     normalize -> BGR->Lab -> clip(L*gain_i, 0, 100) -> Lab->BGR ->
     clip(*255) -> uint8, written straight into the (B, h, w, 3) output.
The kernels are CUDA (csrc/postprocess.cu), one per function pair with
the batch folded into a 1D grid; `lab_l_plan` and `wb_encode_plan` cut
the frames into the kernels' blocks (`lab_l_cta` and `wb_encode_cta`
say which pixels each block takes, as the kernels decode it). Launches
count under the B4/B5 names. The plain versions use ops/color.py.

Sampling: each image's rows are cut into blocks of `_block_geometry`
rows, and with stride s > 1 only every s-th block is summed — the same
pixels the JAX package samples, so the gain agrees to summation order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from fft_restoration_tpu_torch.ops.color import (
    D65,
    M_SRGB2XYZ,
    M_XYZ2SRGB,
    bgr_to_lab_planar,
    lab_to_bgr_planar,
    luminance_l_planar,
)
from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda, u8_to_unit

# threads a CUDA block of both kernels (csrc/postprocess.cu PP_THREADS);
# a thread takes 4 consecutive pixels of a row
THREADS = 256
# rows a thread takes (measured, tools/rows_geometry.py: 4 reads within
# 5% of the best of 1, 2, 4 and 8 in every case; B4's blocks each build
# their table, so fewer and longer blocks pay it less often)
ROWS_A_THREAD = 4
# the color matrices for the kernels, as the plain version multiplies them
_COLOR = np.array([*sum(M_SRGB2XYZ, []), *sum(M_XYZ2SRGB, []), *D65], np.float32)
_COLOR_PTR = _COLOR.ctypes.data


def _block_geometry(h, w, block_rows):
    """Row-block size: 8-aligned, VMEM-bounded (~12 live (rows, W) f32
    blocks across the two kernels' inputs/outputs/temporaries). Copied
    from the JAX package: it decides which rows the strided statistics
    sample, so it stays as the TPU chose it."""
    wp = -(-w // 128) * 128
    budget = 24 << 20
    max_rows = max(8, (budget // (wp * 4 * 12)) // 8 * 8)
    rows = min(block_rows, max_rows) // 8 * 8
    rows = max(rows, 8)
    hp = -(-h // rows) * rows
    return rows, hp, wp


def effective_wb_stride(h_live: int, stride: int) -> int:
    """Clamp the WB-stats stride so at least ~8 8-row stripes intersect
    the LIVE image: below 64*stride live rows fall back to exact means."""
    return stride if stride > 1 and h_live >= 64 * stride else 1


def sampled_live_pixels(
    h0: int, w0: int, live_hw=None, block_rows: int = 64, stride: int = 1
) -> int:
    """Pixel count the strided partials sum over (the mean denominator).
    stride=1 -> full live h*w."""
    h, w = live_hw if live_hw is not None else (h0, w0)
    rows, hp, _ = _block_geometry(h0, w0, block_rows)
    n_blocks = hp // rows
    return sum(
        max(0, min(h - j * rows, rows)) for j in range(0, n_blocks, stride)
    ) * w


def _check_raw(raw, lo, scale, live_hw):
    """Shared operand checks; returns the batch B = lo.numel() // 3."""
    if lo.ndim != 1 or lo.shape != scale.shape or lo.shape[0] % 3 or lo.shape[0] == 0:
        raise ValueError("lo and scale must be (3B,) per-plane tensors")
    if raw.ndim != 3 or raw.shape[0] < lo.shape[0] or raw.dtype != torch.float32:
        raise ValueError(
            f"need (C>={lo.shape[0]}, H, W) float32 planes, got {tuple(raw.shape)} {raw.dtype}"
        )
    h, w = live_hw
    if not (0 < h <= raw.shape[1] and 0 < w <= raw.shape[2]):
        raise ValueError(f"live extent {live_hw} outside the planes {tuple(raw.shape[1:])}")
    return lo.shape[0] // 3


def _normalized(raw, lo, scale):
    return (raw[: lo.shape[0]] - lo[:, None, None]) * scale[:, None, None]


def lab_l_sum_partials_batched_plain(raw, orig, lo, scale, live_hw, stride=1, block_rows=64):
    """Plain version of `lab_l_sum_partials_batched` (same signature and
    layout)."""
    b = _check_raw(raw, lo, scale, live_hw)
    h0, w0 = raw.shape[1:]
    h, w = live_hw
    rows, hp, wp = _block_geometry(h0, w0, block_rows)
    orig = u8_to_unit(orig) if orig.dtype == torch.uint8 else orig
    nb = _normalized(raw, lo, scale)[:, :h, :w].reshape(b, 3, h, w)
    sums = []
    for src in (nb, orig):
        full = torch.zeros((b, hp, wp), dtype=torch.float32, device=raw.device)
        full[:, :h, :w] = luminance_l_planar(src[:, 0], src[:, 1], src[:, 2])
        sums.append(full.reshape(b, hp // rows, rows * wp)[:, ::stride].sum(-1))
    return torch.stack(sums, dim=-1)


def columns_log2(w: int) -> int:
    """log2 of TX, the 4-pixel groups a block row takes (32..256): the
    fewest idle threads on a live row of w pixels, the widest on a tie.
    The block's other THREADS // TX threads take as many rows."""
    groups = -(-w // 4)
    best = None
    for t in range(5, THREADS.bit_length()):
        idle = -(-groups // (1 << t) << t) - groups
        if best is None or idle <= best[0]:
            best = (idle, t)
    return best[1]


class LabPlan(NamedTuple):
    """B4/B8a's launch: images, live extent, the sampled row blocks of
    `rows` rows (every `stride`-th of the plane's), each cut into
    `n_slabs` slabs of `slab` rows by `n_chunks` chunks of 4 * TX
    columns, one CUDA block each."""
    b: int
    h: int
    w: int
    rows: int
    stride: int
    n_blocks: int
    tx_log2: int
    slab: int
    n_slabs: int
    n_chunks: int

    @property
    def n_ctas(self) -> int:
        return self.b * self.n_blocks * self.n_slabs * self.n_chunks


@functools.lru_cache(maxsize=256)
def lab_l_plan(b, h0, w0, live_hw, stride=1, block_rows=64,
               rows_a_thread=ROWS_A_THREAD) -> LabPlan:
    """The launch of B4/B8a over B images of (h0, w0) planes: a slab is
    TY * rows_a_thread rows, at most a row block. live_hw a tuple (the
    plan is cached per shape: the wrappers' host time is on the single
    frame's critical path)."""
    h, w = live_hw
    rows, hp, _ = _block_geometry(h0, w0, block_rows)
    t = columns_log2(w)
    slab = min((THREADS >> t) * rows_a_thread, rows)
    return LabPlan(b, h, w, rows, stride, -(-(hp // rows) // stride), t, slab, -(-rows // slab),
                   -(-w // (4 << t)))


def lab_l_cta(plan: LabPlan, k: int) -> tuple:
    """CUDA block k of a LabPlan, decoded as lab_l_partials_kernel does:
    (image, sampled row block, rows [r0, r1), columns [c0, c1)) of the live
    frame; its partial pair is parts[image, block, k % (n_slabs *
    n_chunks)]. Thread (tx, ty) takes columns c0 + 4 tx .. + 3 of rows r0 +
    ty, r0 + ty + TY, ... (TX = 1 << tx_log2, TY = THREADS // TX)."""
    k, chunk = divmod(k, plan.n_chunks)
    k, slab = divmod(k, plan.n_slabs)
    img, blk = divmod(k, plan.n_blocks)
    start = blk * plan.stride * plan.rows
    r0 = start + slab * plan.slab
    r1 = min(r0 + plan.slab, start + plan.rows, plan.h)
    c0 = chunk << (plan.tx_log2 + 2)
    return img, blk, r0, max(r0, r1), min(c0, plan.w), min(c0 + (4 << plan.tx_log2), plan.w)


class EncPlan(NamedTuple):
    """B5/B8b's launch: each image's live frame cut into `n_slabs` slabs
    of `slab` rows by `n_chunks` chunks of 4 * TX columns, one CUDA
    block each."""
    b: int
    h: int
    w: int
    tx_log2: int
    slab: int
    n_slabs: int
    n_chunks: int

    @property
    def n_ctas(self) -> int:
        return self.b * self.n_slabs * self.n_chunks


@functools.lru_cache(maxsize=256)
def wb_encode_plan(b, live_hw, rows_a_thread=ROWS_A_THREAD) -> EncPlan:
    """The launch of B5/B8b over B images of live extent (h, w), a tuple:
    a slab is TY * rows_a_thread rows (cached per shape)."""
    h, w = live_hw
    t = columns_log2(w)
    slab = (THREADS >> t) * rows_a_thread
    return EncPlan(b, h, w, t, slab, -(-h // slab), -(-w // (4 << t)))


def wb_encode_cta(plan: EncPlan, k: int) -> tuple:
    """CUDA block k of an EncPlan, decoded as wb_encode_kernel does:
    (image, rows [r0, r1), columns [c0, c1)); threads as in `lab_l_cta`.
    A thread's 4 pixels go out as three 32-bit words when their 12 bytes
    are whole and 4-byte aligned in the (B, h, w, 3) stack, else byte by
    byte."""
    k, chunk = divmod(k, plan.n_chunks)
    img, slab = divmod(k, plan.n_slabs)
    r0 = slab * plan.slab
    c0 = chunk << (plan.tx_log2 + 2)
    return img, r0, min(r0 + plan.slab, plan.h), c0, min(c0 + (4 << plan.tx_log2), plan.w)


def _check_norm(lo, scale):
    for t in (lo, scale):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lo and scale must be contiguous float32 tensors")


def _launch_lab(raw, orig, lo, scale, plan: LabPlan):
    """One launch of lab_l_partials_kernel; returns the (B, n_blocks,
    n_slabs * n_chunks, 2) per-block partials."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    h0, w0 = raw.shape[1:]
    parts = torch.empty((plan.b, plan.n_blocks, plan.n_slabs * plan.n_chunks, 2),
                        dtype=torch.float32, device=raw.device)
    u8 = orig.dtype == torch.uint8
    words = u8 and orig.stride(1) == 1 and orig.stride(3) == 3 and orig.data_ptr() % 4 == 0
    err = _build.load().lab_l_partials_launch(
        raw.data_ptr(), orig.data_ptr(), int(u8), lo.data_ptr(), scale.data_ptr(),
        parts.data_ptr(), h0 * w0, w0, *orig.stride(), int(words), plan.h, plan.w, plan.rows,
        plan.stride, plan.n_blocks, plan.slab, plan.n_slabs, plan.n_chunks, plan.tx_log2,
        plan.n_ctas, int(w0 % 4 == 0 and raw.data_ptr() % 16 == 0), _COLOR_PTR,
        torch.cuda.current_stream(raw.device).cuda_stream,
    )
    _build.check(err, "lab_l_sum_partials")
    return parts


def lab_l_sum_partials_batched(raw, orig, lo, scale, live_hw, stride=1, block_rows=64):
    """Lab-L block sums of the normalized restored planes and the originals
    of a stack of B images, in one launch (B8a; B4 is its B = 1 case).

    raw:   (C>=3B, H0, W0) contiguous float32 raw inverse-FFT planes, image
           i's BGR channels at planes 3i..3i+2 (a packed stack's phantom
           plane 3B is never read); normalized in the pass as
           (raw - lo[q]) * scale[q], lo/scale (3B,) contiguous float32.
    orig:  (B, 3, h, w) uint8 or float32 original BGR planes, any strides —
           `stack.permute(0, 3, 1, 2)` of the (B, h, w, 3) input reads it
           in place (as 32-bit words); uint8 converts as x / 255.
    live_hw=(h, w): only this top-left extent of each raw plane counts.
    stride: sum every stride-th row block of `_block_geometry` rows, per
    image. Returns (B, n_blocks, 2) float32: [..., 0] sums restored L,
    [..., 1] original L, per image and sampled row block; each block's
    slabs and chunks summed in a fixed order (no atomics).
    """
    if not on_cuda(raw, orig, lo, scale):
        return lab_l_sum_partials_batched_plain(raw, orig, lo, scale, live_hw, stride, block_rows)
    b = _check_raw(raw, lo, scale, live_hw)
    _check_norm(lo, scale)
    if not raw.is_contiguous():
        raise ValueError("raw planes must be contiguous")
    h0, w0 = raw.shape[1:]
    h, w = live_hw
    if orig.shape != (b, 3, h, w) or orig.dtype not in (torch.uint8, torch.float32):
        raise ValueError(
            f"orig must be ({b}, 3, {h}, {w}) uint8/float32, got {tuple(orig.shape)}"
        )
    parts = _launch_lab(raw, orig, lo, scale, lab_l_plan(b, h0, w0, (h, w), stride, block_rows))
    launch_counts["lab_l_sum_partials"] += 1
    return parts.sum(dim=2)


def lab_l_sum_partials_plain(raw, orig, lo, scale, live_hw, stride=1, block_rows=64):
    """Plain version of `lab_l_sum_partials` (same signature and layout)."""
    return lab_l_sum_partials_batched_plain(
        raw, orig[None], lo, scale, live_hw, stride, block_rows
    )[0]


def lab_l_sum_partials(raw, orig, lo, scale, live_hw, stride=1, block_rows=64):
    """Lab-L block sums of one frame (B4): `lab_l_sum_partials_batched`
    with B = 1 — orig (3, h, w), lo/scale (3,); returns (n_blocks, 2)."""
    return lab_l_sum_partials_batched(raw, orig[None], lo, scale, live_hw, stride, block_rows)[0]


def wb_encode_u8_batched_plain(raw, gains, lo, scale, live_hw):
    """Plain version of `wb_encode_u8_batched` (same signature and layout)."""
    b = _check_raw(raw, lo, scale, live_hw)
    h, w = live_hw
    nb = _normalized(raw, lo, scale)[:, :h, :w].reshape(b, 3, h, w)
    L, a, bb = bgr_to_lab_planar(nb[:, 0], nb[:, 1], nb[:, 2])
    L = torch.clamp(L * gains.reshape(b, 1, 1), 0.0, 100.0)
    return torch.stack(
        [
            # truncate through int32, as the JAX encode does
            torch.clamp(p * 255.0, 0.0, 255.0).to(torch.int32).to(torch.uint8)
            for p in lab_to_bgr_planar(L, a, bb)
        ],
        dim=-1,
    )


def _launch_encode(raw, gains, lo, scale, plan: EncPlan):
    """One launch of wb_encode_kernel; returns the (B, h, w, 3) uint8 stack."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    h0, w0 = raw.shape[1:]
    out = torch.empty((plan.b, plan.h, plan.w, 3), dtype=torch.uint8, device=raw.device)
    err = _build.load().wb_encode_launch(
        raw.data_ptr(), gains.data_ptr(), lo.data_ptr(), scale.data_ptr(), out.data_ptr(),
        h0 * w0, w0, plan.h, plan.w, plan.slab, plan.n_slabs, plan.n_chunks, plan.tx_log2,
        plan.n_ctas, int(w0 % 4 == 0 and raw.data_ptr() % 16 == 0), _COLOR_PTR,
        torch.cuda.current_stream(raw.device).cuda_stream,
    )
    _build.check(err, "wb_encode_u8")
    return out


def wb_encode_u8_batched(raw, gains, lo, scale, live_hw):
    """White-balanced uint8 encode of a stack of B images in one pass over
    the raw planes (B8b; B5 is its B = 1 case).

    raw, lo, scale, live_hw: as in `lab_l_sum_partials_batched`; gains:
    (B,) float32 per-image gains (mean(L_orig) / (mean(L_deblur) + 1e-6)).
    Returns the (B, h, w, 3) uint8 BGR stack: the interleave of each
    image's three channel planes happens in the kernel's store.
    """
    if not on_cuda(raw, gains, lo, scale):
        return wb_encode_u8_batched_plain(raw, gains, lo, scale, live_hw)
    b = _check_raw(raw, lo, scale, live_hw)
    _check_norm(lo, scale)
    if not raw.is_contiguous():
        raise ValueError("raw planes must be contiguous")
    if gains.shape != (b,) or gains.dtype != torch.float32 or not gains.is_contiguous():
        raise ValueError(f"gains must be a contiguous ({b},) float32 tensor")
    out = _launch_encode(raw, gains, lo, scale, wb_encode_plan(b, tuple(live_hw)))
    launch_counts["wb_encode_u8"] += 1
    return out


def wb_encode_u8_plain(raw, gain, lo, scale, live_hw):
    """Plain version of `wb_encode_u8` (same signature and layout)."""
    return wb_encode_u8_batched_plain(raw, gain.reshape(1), lo, scale, live_hw)[0]


def wb_encode_u8(raw, gain, lo, scale, live_hw):
    """White-balanced uint8 encode of one frame (B5):
    `wb_encode_u8_batched` with B = 1 — gain a one-element float32
    tensor, lo/scale (3,); returns the (h, w, 3) uint8 frame."""
    return wb_encode_u8_batched(raw, gain.reshape(1), lo, scale, live_hw)[0]
