"""White-balance post-processing (B4/B5) — wrappers, plain versions and
the block geometry that decides which pixels feed the gain.

Counterpart of fft_restoration_tpu/ops/pallas/postprocess.py:
  B4 `lab_l_sum_partials`: in one pass over the raw restored planes and
     the original frame, the fused min-max normalize and the Lab-L block
     sums of both (the white-balance gain's two means);
  B5 `wb_encode_u8`: normalize -> BGR->Lab -> clip(L*gain, 0, 100) ->
     Lab->BGR -> clip(*255) -> uint8, written straight into the (h, w, 3)
     output frame.
The kernels are Triton (postprocess_triton.py, imported only when a
kernel launches); the plain versions use ops/color.py.

Sampling: rows are cut into blocks of `_block_geometry` rows, and with
stride s > 1 only every s-th block is summed — the same pixels the JAX
package samples, so the gain agrees to summation order.
"""

from __future__ import annotations

import torch

from fft_restoration_tpu_torch.ops.color import (
    bgr_to_lab_planar,
    lab_to_bgr_planar,
    luminance_l_planar,
)
from fft_restoration_tpu_torch.ops.kernels import launch_counts, on_cuda

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
    if raw.ndim != 3 or raw.shape[0] < 3 or raw.dtype != torch.float32:
        raise ValueError(f"need (C>=3, H, W) float32 planes, got {tuple(raw.shape)} {raw.dtype}")
    if lo.shape != (3,) or scale.shape != (3,):
        raise ValueError("lo and scale must be (3,) per-channel tensors")
    h, w = live_hw
    if not (0 < h <= raw.shape[1] and 0 < w <= raw.shape[2]):
        raise ValueError(f"live extent {live_hw} outside the planes {tuple(raw.shape[1:])}")


def _normalized(raw, lo, scale):
    return (raw[:3] - lo[:, None, None]) * scale[:, None, None]


def lab_l_sum_partials_plain(raw, orig, lo, scale, live_hw, stride=1, block_rows=64):
    """Plain version of `lab_l_sum_partials` (same signature and layout)."""
    _check_raw(raw, lo, scale, live_hw)
    h0, w0 = raw.shape[1:]
    h, w = live_hw
    rows, hp, wp = _block_geometry(h0, w0, block_rows)
    orig = orig.to(torch.float32) / 255.0 if orig.dtype == torch.uint8 else orig
    nb = _normalized(raw, lo, scale)[:, :h, :w]
    sums = []
    for src in (nb, orig):
        full = torch.zeros((hp, wp), dtype=torch.float32, device=raw.device)
        full[:h, :w] = luminance_l_planar(src[0], src[1], src[2])
        sums.append(full.reshape(hp // rows, rows * wp)[::stride].sum(-1))
    return torch.stack(sums, dim=-1)


def lab_l_sum_partials(raw, orig, lo, scale, live_hw, stride=1, block_rows=64):
    """Lab-L block sums of the normalized restored planes and the original.

    raw:   (C>=3, H0, W0) contiguous float32 raw inverse-FFT planes (only
           the first 3 are read); normalized in the pass as
           (raw - lo[c]) * scale[c], lo/scale (3,) tensors.
    orig:  (3, h, w) uint8 or float32 original BGR planes, any strides —
           `frame.permute(2, 0, 1)` of the (h, w, 3) input reads it in
           place; uint8 converts as x / 255.
    live_hw=(h, w): only this top-left extent of raw contributes.
    stride: sum every stride-th row block of `_block_geometry` rows.
    Returns (n_blocks, 2) float32: column 0 sums restored L, column 1
    original L, per sampled row block.
    """
    if not on_cuda(raw, orig, lo, scale):
        return lab_l_sum_partials_plain(raw, orig, lo, scale, live_hw, stride, block_rows)
    from fft_restoration_tpu_torch.ops.kernels import postprocess_triton

    _check_raw(raw, lo, scale, live_hw)
    if not raw.is_contiguous():
        raise ValueError("raw planes must be contiguous")
    h0, w0 = raw.shape[1:]
    h, w = live_hw
    if orig.shape != (3, h, w) or orig.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"orig must be (3, {h}, {w}) uint8/float32, got {tuple(orig.shape)}")
    rows, hp, _ = _block_geometry(h0, w0, block_rows)
    n_blocks = -(-(hp // rows) // stride)
    n_chunks = -(-w // BLOCK_W)
    parts = torch.empty((n_blocks, n_chunks, 2), dtype=torch.float32, device=raw.device)
    postprocess_triton.lab_l_partials_kernel[(n_blocks, n_chunks)](
        raw, orig, lo, scale, parts,
        h0 * w0, w0, *orig.stride(), h, w, rows, stride,
        ORIG_U8=orig.dtype == torch.uint8, BLOCK_R=BLOCK_R, BLOCK_W=BLOCK_W,
    )
    launch_counts["lab_l_sum_partials"] += 1
    return parts.sum(dim=1)


def wb_encode_u8_plain(raw, gain, lo, scale, live_hw):
    """Plain version of `wb_encode_u8` (same signature and layout)."""
    _check_raw(raw, lo, scale, live_hw)
    h, w = live_hw
    nb = _normalized(raw, lo, scale)[:, :h, :w]
    L, a, b = bgr_to_lab_planar(nb[0], nb[1], nb[2])
    L = torch.clamp(L * gain, 0.0, 100.0)
    return torch.stack(
        [
            # truncate through int32, as the JAX encode does
            torch.clamp(p * 255.0, 0.0, 255.0).to(torch.int32).to(torch.uint8)
            for p in lab_to_bgr_planar(L, a, b)
        ],
        dim=-1,
    )


def wb_encode_u8(raw, gain, lo, scale, live_hw):
    """White-balanced uint8 encode in one pass over the raw planes.

    raw, lo, scale, live_hw: as in `lab_l_sum_partials`; gain: a one-
    element float32 tensor (mean(L_orig) / (mean(L_deblur) + 1e-6)).
    Returns the (h, w, 3) uint8 BGR frame: the interleave of the three
    channel planes happens in the kernel's store.
    """
    if not on_cuda(raw, gain, lo, scale):
        return wb_encode_u8_plain(raw, gain, lo, scale, live_hw)
    from fft_restoration_tpu_torch.ops.kernels import postprocess_triton

    _check_raw(raw, lo, scale, live_hw)
    if not raw.is_contiguous():
        raise ValueError("raw planes must be contiguous")
    if gain.numel() != 1 or gain.dtype != torch.float32:
        raise ValueError("gain must be a one-element float32 tensor")
    h0, w0 = raw.shape[1:]
    h, w = live_hw
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=raw.device)
    grid = (-(-h // BLOCK_R), -(-w // BLOCK_W))
    postprocess_triton.wb_encode_kernel[grid](
        raw, gain, lo, scale, out, h0 * w0, w0, h, w,
        BLOCK_R=BLOCK_R, BLOCK_W=BLOCK_W,
    )
    launch_counts["wb_encode_u8"] += 1
    return out
