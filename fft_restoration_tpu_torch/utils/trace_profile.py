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

Every range is also kept in memory (`Recorder`, read by `snapshot`): the
`fphase_` ranges and the `frequest` range the pipelines open around each
request (outside the phase taxonomy, so rows in no phase still read
'unattributed'). A record holds its request's id, its name, the span
that holds it on its thread, and its start and end on the wall clock
(`time.time_ns`), the clock of the exported trace: a chrome-trace `ts`
is (ns - baseTimeNanoseconds) / 1e3, and each record lies inside its
range, the clock read right after it opens and right before it closes
(`_Range`). A request record holds its frame count and the counts it
caused (`count`: the PSF cache's, and RL's iterations and convolutions).
The records and counters are kept only while a profiler records, the one
gate of `fphase`: a pipeline run costs the gate's check, and nothing is
kept, when tracing is off.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

import torch

PHASE_PREFIX = "fphase_"
REQUEST = "frequest"  # a pipeline request's range: no phase, so outside the taxonomy
# spans the ring keeps: ~500 requests of the kernel route's 5-8 spans, or
# 124 of RL's 33 at 10 iterations (models/richardson_lucy.py)
RING_SPANS = 4096
# chrome-trace categories of the device's own work (the device-row filter)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that launch device work, carrying the row's correlation id
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_NO_RANGE = contextlib.nullcontext()


@dataclass
class Span:
    """One range's in-memory record. id: sequential over the process;
    request: the id of the request it belongs to (its own for a
    `frequest`), None outside every request; parent: the id of the span
    that held it on its thread, None for a root; start_ns, end_ns: wall
    clock (module docstring); child_ns: the time its child spans cover;
    frames, counters: a request's frame count and PSF-cache counts."""

    id: int
    name: str
    request: int | None
    parent: int | None
    start_ns: int
    end_ns: int = 0
    child_ns: int = 0
    frames: int = 0
    counters: dict = field(default_factory=dict)

    @property
    def self_ns(self) -> int:
        """Its duration less the part its child spans cover."""
        return self.end_ns - self.start_ns - self.child_ns


@dataclass
class Snapshot:
    """What `snapshot` returns. spans: records, oldest root first, each
    after its children; host_ms, self_ms: total ms and self ms of the
    spans by name; counters: the selected requests' counts (the
    process's totals when nothing is selected); requests: request spans
    among spans; dropped: spans the ring has let go since it began."""

    spans: list
    host_ms: dict
    self_ms: dict
    counters: dict
    requests: int
    dropped: int


class Recorder:
    """The ranges' records and the counters, kept while a profiler
    records. A span belongs to its thread's stack of open spans (the
    server runs requests on threads of its own); a root span and its
    descendants enter the ring together when the root closes, and the
    ring lets whole roots go, oldest first, beyond `capacity` spans,
    counting them in `dropped`."""

    def __init__(self, capacity: int = RING_SPANS):
        self.capacity = capacity
        self.dropped = 0
        self.counters = {}  # totals, whatever span was open
        self._ring = deque()  # tuples: a root span's descendants, then the root
        self._held = 0
        self._ids = itertools.count()
        self._requests = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.closed = [], []
        return local.stack

    def open(self, name: str, start_ns: int, frames: int = 0) -> Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        request = next(self._requests) if name == REQUEST else (
            parent.request if parent else None)
        span = Span(next(self._ids), name, request, parent.id if parent else None, start_ns,
                    frames=frames)
        stack.append(span)
        return span

    def close(self, span: Span, end_ns: int) -> None:
        span.end_ns = end_ns
        stack, closed = self._local.stack, self._local.closed
        stack.pop()  # the innermost: ranges close in the order they nest
        closed.append(span)
        if stack:
            stack[-1].child_ns += span.end_ns - span.start_ns
            return
        self._local.closed = []
        with self._lock:
            self._ring.append(tuple(closed))
            self._held += len(closed)
            while self._held > self.capacity:
                gone = self._ring.popleft()
                self._held -= len(gone)
                self.dropped += len(gone)

    def count(self, name: str, n: int = 1) -> None:
        for span in reversed(self._stack()):
            if span.name == REQUEST:
                span.counters[name] = span.counters.get(name, 0) + n
                break
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self, last_requests: int | None = None, since_ns: int = 0) -> Snapshot:
        with self._lock:
            spans = [s for group in self._ring for s in group if s.start_ns >= since_ns]
            totals, dropped = dict(self.counters), self.dropped
        if last_requests is not None:
            ids = sorted(s.request for s in spans if s.name == REQUEST)
            keep = set(ids[max(0, len(ids) - last_requests):])
            spans = [s for s in spans if s.request in keep]
        host_ms, self_ms, counters = defaultdict(float), defaultdict(float), defaultdict(int)
        for s in spans:
            host_ms[s.name] += (s.end_ns - s.start_ns) / 1e6
            self_ms[s.name] += s.self_ns / 1e6
            if s.name == REQUEST:
                for k, v in s.counters.items():
                    counters[k] += v
        if last_requests is None and not since_ns:
            counters = totals
        return Snapshot(spans=spans, host_ms=dict(host_ms), self_ms=dict(self_ms),
                        counters=dict(counters),
                        requests=sum(s.name == REQUEST for s in spans), dropped=dropped)


RECORDER = Recorder()


class _Range:
    """A record_function range and its record in RECORDER. The clock is
    read right after the range opens and right before it closes, and the
    record's bookkeeping (which may allocate, and so collect garbage)
    runs outside those two reads: the record lies inside the range and
    close to its ends."""

    __slots__ = ("name", "frames", "_fn", "_rec", "_span")

    def __init__(self, name: str, frames: int = 0):
        self.name, self.frames = name, frames

    def __enter__(self):
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        start_ns = time.time_ns()
        self._rec = RECORDER
        self._span = self._rec.open(self.name, start_ns, self.frames)

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        try:
            return self._fn.__exit__(*exc)
        finally:
            self._rec.close(self._span, end_ns)


def fphase(name: str):
    """The `fphase_<name>` range around a pipeline section, and its
    record, while a profiler records, else a no-op context: a
    record_function costs host time on every run (about 10 us on a CPU
    core), and only a trace reads it."""
    if torch.autograd._profiler_enabled():
        return _Range(PHASE_PREFIX + name)
    return _NO_RANGE


def frequest(frames: int):
    """The `frequest` range around one pipeline request of `frames`
    frames, and its record with a new request id, while a profiler
    records, else the no-op context."""
    if torch.autograd._profiler_enabled():
        return _Range(REQUEST, frames)
    return _NO_RANGE


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while a profiler records: on the
    innermost open request of this thread, and to the totals."""
    if torch.autograd._profiler_enabled():
        RECORDER.count(name, n)


def snapshot(last_requests: int | None = None, since_ns: int = 0) -> Snapshot:
    """The records in memory (those that started at or after since_ns;
    of them, with last_requests, the spans of the latest last_requests
    requests), their host and self ms by name, and the counters."""
    return RECORDER.snapshot(last_requests, since_ns)


@dataclass
class DeviceTraceReport:
    """Aggregated device-side timeline for n_iters executions."""

    n_iters: int
    device_total_ms: float  # union of the device rows' intervals / n_iters
    device_span_ms: float  # (last end - first start) / n_iters
    ops_ms: dict = field(default_factory=dict)  # kernel name -> total ms (all iters)
    trace_dir: str = ""
    # reference phase taxonomy per iteration, from the fphase_* ranges
    # (fphase). Fused kernels spanning several reference phases report
    # under 'spectral_fused' (column FFT + Wiener + column IFFT in one
    # kernel) rather than being split by guesswork; rows outside any
    # range land in 'unattributed'.
    phases_ms: dict = field(default_factory=dict)
    # span name -> (host ms, self ms) per iteration, from the in-memory
    # records (snapshot); the traced requests' PSF-cache counts
    spans_ms: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    def report(self, top: int = 12) -> str:
        if not self.ops_ms and self.device_total_ms == 0.0:
            where = f"; trace at {self.trace_dir}" if self.trace_dir else ""
            lines = ["device time not measured: the trace has no device rows (a CPU run, "
                     f"or no CUDA activity){where}"]
        else:
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
        if self.spans_ms:
            lines.append("  spans (host ms a run, self ms a run; the host's clock, "
                         "traced, so with the profiler's cost):")
            for name, (ms, own) in sorted(self.spans_ms.items(), key=lambda kv: -kv[1][0]):
                lines.append(f"    {ms:10.3f} ms {own:10.3f} ms  {name}")
        if self.counters:
            lines.append("  PSF cache: " + ", ".join(
                f"{k} {v}" for k, v in sorted(self.counters.items())))
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


def busy_us(rows) -> float:
    """Device busy of rows: the union of their intervals, so that rows of
    two streams that overlap count once."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((r["ts"], r["ts"] + r["dur"]) for r in rows):
        total += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return total


def device_trace(fn, args=(), n_iters: int = 10, trace_dir: str | None = None):
    """Run fn(*args) n_iters times under torch.profiler (CPU and, where a
    card exists, CUDA activity) and aggregate the device rows, and the
    in-memory records of the traced runs. fn is called once first,
    outside the trace, so builds and caches are warm. The trace is kept
    as trace_dir/trace.json when trace_dir is given. Returns a
    DeviceTraceReport."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        for _ in range(n_iters):
            fn(*args)
        sync()
    snap = snapshot(since_ns=t0)
    with contextlib.ExitStack() as stack:
        out_dir = trace_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="fftr_trace_"))
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        events = load_trace(path)
    rows = device_rows(events)
    span_us = (max(e["ts"] + e["dur"] for e in rows) - min(e["ts"] for e in rows)) if rows else 0.0
    ops = {}
    for e in rows:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e3
    return DeviceTraceReport(
        n_iters=n_iters,
        device_total_ms=busy_us(rows) / 1e3 / n_iters,
        device_span_ms=span_us / 1e3 / n_iters,
        ops_ms=ops,
        trace_dir=trace_dir or "",
        phases_ms=phase_breakdown(events, n_iters),
        spans_ms={k: (v / n_iters, snap.self_ms[k] / n_iters) for k, v in snap.host_ms.items()},
        counters=snap.counters,
    )
