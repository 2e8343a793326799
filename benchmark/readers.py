"""What the metric files read from a run (harness.Run). Each
metrics/<name>.py calls one of these; a reader with nothing to read
returns None, and the harness leaves that metric out of the line."""

from __future__ import annotations

from benchmark.roofline.counts import slice_share
from benchmark.stats import mean, percentile


def setup_s(run):
    """Seconds from the process's start to the first timed request."""
    return run.setup_s


def mpix_per_s(run):
    """Frames completed in the window x h x w / 1e6 over the window's host
    seconds (channels not counted)."""
    if not run.window.frames or run.window.seconds <= 0:
        return None
    return run.window.frames * run.h * run.w / 1e6 / run.window.seconds


def latency_ms(run, q):
    """The q-th percentile (nearest rank) of all of the window's request
    latencies, each from CUDA events around one `run` call."""
    return percentile(run.window.latency_ms, q) if run.window.latency_ms else None


def dispatch_ms(run):
    """Host ms inside the pipeline's `run`, no synchronise, mean over the
    window's calls."""
    return mean(run.window.dispatch_s) * 1e3 if run.window.dispatch_s else None


def psf_device_ms(run):
    """Device ms a request under the fphase_fft_psf range in the traced
    slice (the PSF's row and column passes); None where no PSF spectrum
    was made there."""
    if run.report is None or run.traced is None or not run.traced.requests:
        return None
    seconds = run.report.phases_s.get("fft_psf", 0.0)
    return seconds / run.traced.requests * 1e3 if seconds > 0 else None


def roofline(run):
    """The restore's least time over device busy in the traced slice, %
    (roofline/counts.py)."""
    return slice_share(run)


def idle_share(run):
    """The share of the measured window in which the device ran nothing,
    %: 1 - (device busy a request in the traced slice, the union of its
    rows' intervals) x (requests in the window) / (the window's seconds).
    The slice's own idle share (busy_s over window_s of the result's
    device) holds the profiler's host overhead besides."""
    if run.report is None or run.report.busy_s <= 0 or not run.traced.requests:
        return None
    busy = run.report.busy_s / run.traced.requests * run.window.requests
    return (1.0 - busy / run.window.seconds) * 100.0
