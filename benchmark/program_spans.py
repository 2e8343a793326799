"""What the per-layer metrics read from the program's own spans and
counters: `snapshot()` of the port's utils/trace_profile.py, the records
it keeps in memory of the ranges it opens while a profiler records.

The traced slice's requests are the last `run.traced.requests` requests
the program recorded: the slice is the last thing a run traces, and
nothing is recorded untraced, so a process that traces twice reads each
slice's own. A program that keeps no records (a checkout before them)
gives None; one that holds fewer requests than the slice ran raises,
since a None there would hide a fault of its recorder.
"""

from __future__ import annotations


def slice_snapshot(run):
    """The program's snapshot of the traced slice's requests, or None."""
    if run.traced is None or not run.traced.requests:
        return None
    try:
        from fft_restoration_tpu_torch.utils.trace_profile import snapshot
    except ImportError:
        return None
    snap = snapshot(last_requests=run.traced.requests)
    if snap.requests < run.traced.requests:
        raise RuntimeError(f"the program recorded {snap.requests} of the traced slice's "
                           f"{run.traced.requests} requests ({snap.dropped} spans dropped)")
    return snap


def make_psf_host_ms(run):
    """Host ms a request inside `fphase_make_psf`."""
    snap = slice_snapshot(run)
    return None if snap is None else snap.host_ms.get("fphase_make_psf", 0.0) / snap.requests


def run_self_host_ms(run):
    """Host ms a request inside `frequest` and outside every phase."""
    snap = slice_snapshot(run)
    return None if snap is None else snap.self_ms["frequest"] / snap.requests


def psf_cache_miss_share(run):
    """PSF-cache misses over lookups in the slice's requests, %."""
    snap = slice_snapshot(run)
    lookups = 0 if snap is None else snap.counters.get("psf_lookups", 0)
    return snap.counters.get("psf_misses", 0) / lookups * 100.0 if lookups else None


def make_psf_device_ms(run):
    """Device ms a request of the rows launched under `fphase_make_psf`
    in the traced slice; None where no row was (a CPU run, or a program
    without the range)."""
    if run.report is None or run.traced is None or not run.traced.requests:
        return None
    seconds = run.report.phases_s.get("make_psf", 0.0)
    return seconds / run.traced.requests * 1e3 if seconds > 0 else None
