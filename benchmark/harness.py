"""One run of one cell: set-up, the measured window, the traced slice,
the check against the reference, and the result line.

`run_cell` drives the port (fft_restoration_tpu_torch) and nothing else:
its pipelines' `run`, with frames made on the device from the seed. Set-up
runs from the process's start to the first timed request: the imports,
the CUDA context, the kernel library (built into build/kernels/ of the
checkout by the first run there), the frames and the warm-up, which runs
every PSF length the traffic uses and holds as many outputs as the window
will. With trace on, a slice of `trace_requests` requests after the window
runs under torch.profiler. After that the program's state is freed and the
sampled outputs are compared with the float64 reference that the cell's
configuration names.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import torch

from benchmark import compare, spec
from benchmark.frames import make_pool
from benchmark.trace import REQUEST, TraceReport, trace_slice
from benchmark.traffic import (CudaClock, HostClock, Sampler, Schedule, Window, batch_loop,
                               stream_loop)


@dataclass
class Run:
    """What the metric readers read (metrics/<name>.py: read(run))."""

    cell: spec.Cell
    kind: str  # the traffic's loop: "stream" or "batch"
    h: int
    w: int
    setup_s: float
    window: Window
    device_kind: str
    traced: Window | None = None  # the traced slice's requests
    report: TraceReport | None = None
    new_psfs: int = 0  # PSFs of the traced slice not run before it
    memory_peak_bytes: int = 0


def make_pipeline(config: dict, kind: str, device, over=None):
    from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline

    cls = WienerDeblurPipeline if kind == "stream" else BatchedWienerPipeline
    return cls(device, **dict(config["pipeline"], **(over or {})))


def make_inputs(cell: spec.Cell, seed: int, device) -> torch.Tensor:
    """The cell's pool: (n, h, w, 3) frames, or (n, B, h, w, 3) stacks."""
    cfg, tr = cell.config, cell.traffic
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    per = tr.get("stack", 1)
    n = tr["pool"] * per
    pool = make_pool(seed, n, h, w, (cfg["psf"]["length"], cfg["psf"]["angle"]), device)
    return pool if tr["kind"] == "stream" else pool.reshape(tr["pool"], per, h, w, 3)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start=None, over=None, wrap=None) -> tuple:
    """Run the cell once; returns (Run, the check's dict). over: pipeline
    options over the configuration's (the control); wrap: a function of
    the pipeline that returns what the loops call (tests plant faults)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, tr = cell.config, cell.traffic
    kind = tr["kind"]
    if kind not in ("stream", "batch"):
        raise ValueError(f"unknown traffic kind {kind!r}")
    on_card = torch.device(device).type == "cuda"
    clock = CudaClock() if on_card else HostClock()
    K = float(cfg["K"])
    pool = make_inputs(cell, seed, device)
    pipe = make_pipeline(cfg, kind, device, over)
    target = wrap(pipe) if wrap else pipe
    schedule = Schedule(tr, cfg, seed)

    def loop(sched, **kw):
        if kind == "stream":
            return stream_loop(target, pool, sched, K, clock, **kw)
        return batch_loop(target, pool, sched, K, clock, queued_ahead=tr["queued_ahead"], **kw)

    warm = schedule.warm_points()
    hold = Sampler(tr["sample"] + 2, seed)  # the allocator sees the window's live outputs
    warmed = loop(lambda i: warm[i % len(warm)], count=max(len(warm), tr["warmup"]),
                  sampler=hold)
    del hold
    clock.sync()
    setup_s = time.perf_counter() - t_start

    sampler = Sampler(tr["sample"], seed)
    window = loop(schedule, seconds=seconds, sampler=sampler)
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    run = Run(cell=cell, kind=kind, h=h, w=w, setup_s=setup_s, window=window,
              device_kind=torch.cuda.get_device_name(0) if on_card else "cpu")
    if trace:
        from torch.profiler import record_function

        seen = set(warmed.psfs) | set(window.psfs)
        run.traced, run.report = trace_slice(
            lambda: loop(schedule, count=tr["trace_requests"], start=window.requests,
                         on_request=lambda: record_function(REQUEST)))
        run.new_psfs = len(set(run.traced.psfs) - seen)
    run.memory_peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0

    # the program's state goes before the reference runs
    items = sampler.items()
    del pipe, target, sampler, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return run, compare.check(items, pool, cell)


def result_line(run: Run, checked: dict, trace: bool) -> dict:
    """The JSON object a run prints: the cell's end-to-end metrics (trace
    off) or per-layer metrics (trace on) that have something to read, and
    the numbers compared, last."""
    metrics = {}
    for m in run.cell.per_layer if trace else run.cell.end_to_end:
        value = spec.reader(m["name"], run.cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_kind, "count": run.cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": checked["correct"], "attempted": run.window.frames,
           "failed": checked["failed"], "metrics": metrics, "device": device}
    if trace and run.report is not None:
        device.update(busy_s=run.report.busy_s, window_s=run.report.window_s)
        out["breakdown"] = {"device_ops": run.report.top(run.report.ops_s),
                            "idle_gaps": run.report.top(run.report.gaps_s)}
    out["compared"] = {k: {"value": checked["numbers"][k], "limit": v}
                       for k, v in run.cell.limits.items()}
    return out
