"""From a torch.profiler trace of the traced slice to the numbers the
per-layer metrics read.

The arithmetic of the port's utils/trace_profile.py (device rows, the
innermost `fphase_` range around each row's launch call), with device
busy taken as the union of the rows' intervals, so that rows of two
streams that overlap count once. Besides: the device ops that took most
time, and the device's idle gaps inside the slice by what the host was
doing meanwhile (the innermost host event of the slice's thread at the
gap's middle).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

PHASE_PREFIX = "fphase_"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SLICE = "bench_slice"
REQUEST = "bench_request"
TOP = 10


@dataclass
class TraceReport:
    """busy_s: union of the device rows inside the slice; window_s: the
    slice's length; phases_s: device seconds by `fphase_` range; ops_s:
    device seconds by op name; gaps_s: idle seconds by host activity."""

    busy_s: float
    window_s: float
    phases_s: dict = field(default_factory=dict)
    ops_s: dict = field(default_factory=dict)
    gaps_s: dict = field(default_factory=dict)

    def top(self, table: dict) -> list:
        return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:TOP]]


def union(intervals) -> list:
    """Merged [start, end] intervals of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, lo, hi) -> list:
    return [[max(s, lo), min(e, hi)] for s, e in intervals if e > lo and s < hi]


def device_rows(events) -> list:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]


class Spans:
    """(start, end, name) spans of one thread; `at(t)` names the innermost
    (latest-starting) span that holds t, or None."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t):
        for k in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[k][1] >= t:
                return self.spans[k][2]
        return None


def phases(events, rows) -> dict:
    """Device seconds of each row by the innermost fphase_ range around
    its launch call, 'unattributed' where none is."""
    ranges = defaultdict(list)
    launches = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name, args = str(e.get("name", "")), e.get("args") or {}
        if e.get("cat") == "user_annotation" and name.startswith(PHASE_PREFIX):
            ranges[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"],
                                                 name[len(PHASE_PREFIX):]))
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["pid"], e["tid"], e["ts"])
    spans = {k: Spans(v) for k, v in ranges.items()}
    out = defaultdict(float)
    for row in rows:
        host = launches.get((row.get("args") or {}).get("correlation"))
        phase = None if host is None or host[:2] not in spans else spans[host[:2]].at(host[2])
        out[phase or "unattributed"] += row["dur"] / 1e6
    return dict(out)


def reduce(events) -> TraceReport:
    """The report of the slice that the `bench_slice` range marks."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"the trace has no {SLICE!r} range")
    mark = marks[0]
    lo, hi = mark["ts"], mark["ts"] + mark["dur"]
    rows = [r for r in device_rows(events) if r["ts"] < hi and r["ts"] + r["dur"] > lo]
    busy = clip(union((r["ts"], r["ts"] + r["dur"]) for r in rows), lo, hi)
    ops = defaultdict(float)
    for r in rows:
        ops[str(r["name"])] += r["dur"] / 1e6
    host = Spans((e["ts"], e["ts"] + e["dur"], str(e.get("name", ""))) for e in events
                 if e.get("ph") == "X" and e.get("cat") in HOST_CATS and "dur" in e
                 and (e.get("pid"), e.get("tid")) == (mark.get("pid"), mark.get("tid"))
                 and e.get("name") != SLICE)
    gaps = defaultdict(float)
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps[host.at((s + e) / 2) or "host (no traced call)"] += (e - s) / 1e6
    return TraceReport(busy_s=sum(e - s for s, e in busy) / 1e6, window_s=(hi - lo) / 1e6,
                       phases_s=phases(events, rows), ops_s=dict(ops), gaps_s=dict(gaps))


def trace_slice(fn):
    """Run fn() under torch.profiler (CPU and CUDA activity) inside the
    `bench_slice` range; return (fn's result, TraceReport). The trace is
    written to a temporary file and read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            result = fn()
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return result, reduce(events)
