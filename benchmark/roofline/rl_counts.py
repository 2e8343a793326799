"""Operations and bytes of the Richardson-Lucy restore, counted from its
shapes and its number of iterations.

As in counts.py, the count is of the work, whatever kernels do it, so
that fusing RL's elementwise update into the convolutions' kernels, or
splitting them, cannot move it. At the padded extent of n points:

  * ops: each of the 2 x iters convolutions a frame costs each real
    channel one complex 2D transform's 5 n log2 n (half for the forward,
    half for the inverse); the update's few flops a point are left out;
  * bytes: each byte of the uint8 frames read once and written once; the
    float32 spectrum H (8 B a point) read once a convolution of a run
    call; a float32 iterate read and written once an iteration and the
    blurred plane y read once an iteration, each channel (12 B a point);
    a new PSF writes its H once (counts.psf_work).

A 2048^2 frame at 10 iterations: 2.77e10 ops (0.413 ms at 67 TFLOP/s)
and 25.2 MB + 671.1 MB + 1509.9 MB = 2.206 GB (0.659 ms at 3.35 TB/s),
so memory bounds it at 0.659 ms.
"""

from __future__ import annotations

from benchmark.roofline.counts import (SPECTRUM_BYTES, least_time, padded, psf_work,
                                       transform_ops)

PLANE_BYTES = 4  # a float32 value


def rl_work(h: int, w: int, frames: int, calls: int, iters: int, channels: int = 3) -> tuple:
    """(ops, bytes) of `calls` run calls restoring `frames` frames in all
    by `iters` iterations."""
    n = padded(h, w)
    convs = 2 * iters
    ops = frames * channels * convs * transform_ops(n)
    iterate = frames * channels * iters * 3 * PLANE_BYTES * n
    data = frames * 2 * h * w * channels + calls * convs * SPECTRUM_BYTES * n + iterate
    return ops, data


def slice_share(run):
    """The RL restore's share of its roofline in a run's traced slice: the
    least time of the slice's work (its frames at the configuration's
    `rl_iters`, its run calls and the PSFs it made anew) over the
    device's busy seconds there, in %. None where the slice has no
    device time or the card has no row of peaks."""
    if run.report is None or run.report.busy_s <= 0 or not run.traced:
        return None
    iters = int(run.cell.config["pipeline"]["rl_iters"])
    ops, data = rl_work(run.h, run.w, run.traced.frames, run.traced.requests, iters)
    p_ops, p_data = psf_work(run.h, run.w, run.new_psfs)
    least = least_time(ops + p_ops, data + p_data, run.device_kind)
    return None if least is None else least[0] / run.report.busy_s * 100.0
