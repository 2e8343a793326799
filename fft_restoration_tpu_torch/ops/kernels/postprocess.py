"""White-balance post-processing (B4/B5, B8a/B8b) — wrappers, plain
versions and the block geometry that decides which pixels feed the gain.

Counterpart of fft_restoration_tpu/ops/pallas/postprocess.py:
  B8a `lab_l_sum_partials_batched` (B4 `lab_l_sum_partials` is its B = 1
     case): in one pass over the raw restored planes and the original
     frames, the fused per-plane min-max normalize and the Lab-L block
     sums of both (each image's white-balance gain's two means);
  B8b `wb_encode_u8_batched` (B5 `wb_encode_u8` is its B = 1 case):
     normalize -> BGR->Lab -> clip(L*gain_i, 0, 100) -> Lab->BGR ->
     clip(*255) -> uint8, written straight into the (B, h, w, 3) output.
The kernels are Triton (postprocess_triton.py, imported only when a
kernel launches), one per function pair with the batch on grid axis 0;
launches count under the B4/B5 names. The plain versions use
ops/color.py.

Sampling: each image's rows are cut into blocks of `_block_geometry`
rows, and with stride s > 1 only every s-th block is summed — the same
pixels the JAX package samples, so the gain agrees to summation order.
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.ops.color import (
    bgr_to_lab_planar,
    lab_to_bgr_planar,
    luminance_l_planar,
)
from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda, u8_to_unit

# Triton tile of both kernels: rows x columns per step
BLOCK_R = 8
BLOCK_W = 256


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


def lab_l_sum_partials_batched(raw, orig, lo, scale, live_hw, stride=1, block_rows=64):
    """Lab-L block sums of the normalized restored planes and the originals
    of a stack of B images, in one launch (B8a; B4 is its B = 1 case).

    raw:   (C>=3B, H0, W0) contiguous float32 raw inverse-FFT planes, image
           i's BGR channels at planes 3i..3i+2 (a packed stack's phantom
           plane 3B is never read); normalized in the pass as
           (raw - lo[q]) * scale[q], lo/scale (3B,) per-plane tensors.
    orig:  (B, 3, h, w) uint8 or float32 original BGR planes, any strides —
           `stack.permute(0, 3, 1, 2)` of the (B, h, w, 3) input reads it
           in place; uint8 converts as x / 255.
    live_hw=(h, w): only this top-left extent of each raw plane counts.
    stride: sum every stride-th row block of `_block_geometry` rows, per
    image. Returns (B, n_blocks, 2) float32: [..., 0] sums restored L,
    [..., 1] original L, per image and sampled row block.
    """
    if not on_cuda(raw, orig, lo, scale):
        return lab_l_sum_partials_batched_plain(raw, orig, lo, scale, live_hw, stride, block_rows)
    from fft_restoration_tpu_torch.ops.kernels import postprocess_triton

    b = _check_raw(raw, lo, scale, live_hw)
    if not raw.is_contiguous():
        raise ValueError("raw planes must be contiguous")
    h0, w0 = raw.shape[1:]
    h, w = live_hw
    if orig.shape != (b, 3, h, w) or orig.dtype not in (torch.uint8, torch.float32):
        raise ValueError(
            f"orig must be ({b}, 3, {h}, {w}) uint8/float32, got {tuple(orig.shape)}"
        )
    rows, hp, _ = _block_geometry(h0, w0, block_rows)
    n_blocks = -(-(hp // rows) // stride)
    n_chunks = -(-w // BLOCK_W)
    parts = torch.empty((b, n_blocks, n_chunks, 2), dtype=torch.float32, device=raw.device)
    postprocess_triton.lab_l_partials_kernel[(b, n_blocks, n_chunks)](
        raw, orig, lo, scale, parts,
        h0 * w0, w0, *orig.stride(), h, w, rows, stride,
        ORIG_U8=orig.dtype == torch.uint8, BLOCK_R=BLOCK_R, BLOCK_W=BLOCK_W,
    )
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
    from fft_restoration_tpu_torch.ops.kernels import postprocess_triton

    b = _check_raw(raw, lo, scale, live_hw)
    if not raw.is_contiguous():
        raise ValueError("raw planes must be contiguous")
    if gains.shape != (b,) or gains.dtype != torch.float32 or not gains.is_contiguous():
        raise ValueError(f"gains must be a contiguous ({b},) float32 tensor")
    h0, w0 = raw.shape[1:]
    h, w = live_hw
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=raw.device)
    grid = (b, -(-h // BLOCK_R), -(-w // BLOCK_W))
    postprocess_triton.wb_encode_kernel[grid](
        raw, gains, lo, scale, out, h0 * w0, w0, h, w,
        BLOCK_R=BLOCK_R, BLOCK_W=BLOCK_W,
    )
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
