"""Device-timeline profiling via torch.profiler traces.

Counterpart of fft_restoration_tpu/utils/trace_profile.py over
torch.profiler instead of jax.profiler. The host-clock phase profiler
(utils/timing.py, models/pipeline.py profile_phases) synchronizes after
every phase, and a host clock around queued CUDA work measures the
enqueue, not the device. This module measures what the reference's
cudaEvent Profiler measures: time ON THE DEVICE.

`device_trace` runs a function under torch.profiler with CPU and CUDA
activity, exports the trace in torch's chrome-trace format and reads its
device rows (kernels, copies and fills; not the device-side copies of
user annotations, which span other rows): the time per kernel name,
device busy and span per iteration, and the phase breakdown.

The phases are the `fphase_<phase>` ranges the pipelines open around
their sections (`fphase`, models/pipeline.py). A device row belongs to
the innermost range that launched it. The port launches its kernels
through ctypes (ops/kernels/_build.py), so no torch operator stands
between a launch and the range: a row is traced back through its
`correlation` to the host's runtime or driver launch call, then to the
innermost range around that call on the same thread. Rows no range
claims, or whose launch call is not in the trace, go under
'unattributed'.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

PHASE_PREFIX = "fphase_"
# chrome-trace categories of the device's own work (the device-row filter)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that launch device work, carrying the row's correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_NO_RANGE = contextlib.nullcontext()


def fphase(name: str):
    """The `fphase_<name>` range around a pipeline section while a
    profiler records, else a no-op context: a record_function costs host
    time on every run (about 10 us on a CPU core), and only a trace reads
    it."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PHASE_PREFIX + name)
    return _NO_RANGE


@dataclass
class DeviceTraceReport:
    """Aggregated device-side timeline for n_iters executions."""

    n_iters: int
    device_total_ms: float  # sum of device row durations / n_iters
    device_span_ms: float  # (last end - first start) / n_iters
    ops_ms: dict = field(default_factory=dict)  # kernel name -> total ms (all iters)
    trace_dir: str = ""
    # reference phase taxonomy per iteration, from the fphase_* ranges
    # (fphase). Fused kernels spanning several reference phases report
    # under 'spectral_fused' (column FFT + Wiener + column IFFT in one
    # kernel) rather than being split by guesswork; rows outside any
    # range land in 'unattributed'.
    phases_ms: dict = field(default_factory=dict)

    def report(self, top: int = 12) -> str:
        if not self.ops_ms and self.device_total_ms == 0.0:
            where = f"; trace at {self.trace_dir}" if self.trace_dir else ""
            return ("device time not measured: the trace has no device rows (a CPU run, "
                    f"or no CUDA activity){where}")
        lines = [
            f"device timeline over {self.n_iters} iterations "
            "(torch.profiler trace; device rows only, no host time):",
            f"  device busy : {self.device_total_ms:.3f} ms/iter",
            f"  device span : {self.device_span_ms:.3f} ms/iter",
        ]
        if self.phases_ms:
            lines.append("  phases (ms/iter, reference taxonomy):")
            for name, ms in sorted(self.phases_ms.items(), key=lambda kv: -kv[1]):
                lines.append(f"    {ms:10.3f} ms  {name}")
        lines.append("  top kernels (total across iters):")
        for name, ms in sorted(self.ops_ms.items(), key=lambda kv: -kv[1])[:top]:
            lines.append(f"    {ms:10.3f} ms  {name[:80]}")
        if self.trace_dir:
            lines.append(f"  full trace (Perfetto, chrome://tracing): {self.trace_dir}")
        return "\n".join(lines)


def load_trace(path: str) -> list:
    """The events of a chrome trace written by `export_chrome_trace`."""
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def device_rows(events) -> list:
    """The device's own work: complete events of the kernel, copy and fill
    categories (device-side annotation spans and host events excluded)."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]


def _innermost(ranges, t: float):
    """Name of the innermost (latest-starting) range holding time t."""
    best = None
    for start, end, name in ranges:
        if start <= t <= end and (best is None or start >= best[0]):
            best = (start, name)
    return None if best is None else best[1]


def attribute(events) -> list:
    """(device row, phase) for every device row: the innermost fphase_
    range around its host launch call (found by correlation id) on the
    launching thread, or 'unattributed'."""
    ranges = defaultdict(list)  # (pid, tid) -> [(start, end, phase)]
    launches = {}  # correlation id -> (pid, tid, ts) of the launch call
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name, args = e.get("cat"), str(e.get("name", "")), e.get("args") or {}
        if cat == "user_annotation" and name.startswith(PHASE_PREFIX):
            ranges[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e["dur"], name[len(PHASE_PREFIX):]))
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["pid"], e["tid"], e["ts"])
    out = []
    for row in device_rows(events):
        host = launches.get((row.get("args") or {}).get("correlation"))
        phase = None if host is None else _innermost(ranges.get(host[:2], ()), host[2])
        out.append((row, phase or "unattributed"))
    return out


def phase_breakdown(events, n_iters: int = 1) -> dict:
    """Bucket the device rows into the reference's phase taxonomy by the
    fphase_* ranges (see `attribute`). Returns {phase: ms per iteration};
    rows outside every range aggregate under 'unattributed'. The
    reference prints this table on every run; here it comes from the
    device timeline, so it holds no host time."""
    phases = {}
    for row, phase in attribute(events):
        phases[phase] = phases.get(phase, 0.0) + row["dur"] / 1e3 / n_iters
    return phases


def device_trace(fn, args=(), n_iters: int = 10, trace_dir: str | None = None):
    """Run fn(*args) n_iters times under torch.profiler (CPU and, where a
    card exists, CUDA activity) and aggregate the device rows. fn is
    called once first, outside the trace, so builds and caches are warm.
    The trace is kept as trace_dir/trace.json when trace_dir is given.
    Returns a DeviceTraceReport."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(n_iters):
            fn(*args)
        sync()
    with contextlib.ExitStack() as stack:
        out_dir = trace_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="fftr_trace_"))
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        events = load_trace(path)
    rows = device_rows(events)
    total_us = sum(e["dur"] for e in rows)
    span_us = (max(e["ts"] + e["dur"] for e in rows) - min(e["ts"] for e in rows)) if rows else 0.0
    ops = {}
    for e in rows:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e3
    return DeviceTraceReport(
        n_iters=n_iters,
        device_total_ms=total_us / 1e3 / n_iters,
        device_span_ms=span_us / 1e3 / n_iters,
        ops_ms=ops,
        trace_dir=trace_dir or "",
        phases_ms=phase_breakdown(events, n_iters),
    )
