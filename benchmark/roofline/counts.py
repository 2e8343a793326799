"""Operations and bytes of the Wiener restore, counted from its shapes.

The count is of the work, whatever kernels do it, so that fusing or
splitting kernels cannot move it:

  * ops: 5 n log2 n for a complex transform of n points; a real plane's
    2D transform counts half of a complex one. A frame's three channels
    each take a forward and an inverse 2D transform at the padded extent
    (hp * wp points); a new PSF one forward transform.
  * bytes: each byte of the uint8 frames read once and written once, the
    float32 spectrum H (re and im, hp * wp each) read once a `run` call;
    a new PSF writes its H once.

The least time is max(bytes / bandwidth, ops / float32 peak) against the
card's row of peaks.json (the path computes in float32 outside the
tensor cores).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
SPECTRUM_BYTES = 8  # float32 re and im a point


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def padded(h: int, w: int) -> int:
    """Points of the pow2-padded plane of an (h, w) frame."""
    return next_pow2(h) * next_pow2(w)


def transform_ops(points: int) -> float:
    """5 n log2 n: one complex 2D transform of n points."""
    return 5.0 * points * math.log2(points)


def restore_work(h: int, w: int, frames: int, calls: int, channels: int = 3) -> tuple:
    """(ops, bytes) of `calls` run calls restoring `frames` frames in all."""
    n = padded(h, w)
    ops = frames * channels * 2 * 0.5 * transform_ops(n)
    data = frames * 2 * h * w * channels + calls * SPECTRUM_BYTES * n
    return ops, data


def psf_work(h: int, w: int, new_psfs: int) -> tuple:
    """(ops, bytes) of `new_psfs` PSF spectra at the frame's padded extent."""
    n = padded(h, w)
    return new_psfs * 0.5 * transform_ops(n), new_psfs * SPECTRUM_BYTES * n


def peaks(kind: str):
    """The card's row of peaks.json, or None for a card it lacks."""
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def least_time(ops: float, data: float, kind: str):
    """(seconds, 'compute' or 'memory') the card needs at least, or None."""
    row = peaks(kind)
    if row is None:
        return None
    t_ops, t_bytes = ops / row["f32_flops_per_s"], data / row["bytes_per_s"]
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "memory")


def slice_share(run):
    """The restore's share of its roofline in a run's traced slice: the
    least time of the slice's work (its frames, its run calls and the PSFs
    it made anew) over the device's busy seconds there, in %. None where
    the slice has no device time or the card has no row of peaks."""
    if run.report is None or run.report.busy_s <= 0 or not run.traced:
        return None
    ops, data = restore_work(run.h, run.w, run.traced.frames, run.traced.requests)
    p_ops, p_data = psf_work(run.h, run.w, run.new_psfs)
    least = least_time(ops + p_ops, data + p_data, run.device_kind)
    return None if least is None else least[0] / run.report.busy_s * 100.0
