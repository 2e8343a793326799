"""The harness's arithmetic and discovery, and whole runs of small cells
on the CPU: the statistics, the window rate, the trace's union and idle
gaps, the roofline counts at each cell's shapes, files found by name, the
result line's keys, `correct` under the control and under planted faults,
and the exit without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spec, stats, trace
from benchmark.roofline import counts
from benchmark.tests.conftest import ROOT, TINY
from benchmark.traffic import Sampler, Schedule, Window

SEED = 2**31 + 987654321  # larger than 32 signed bits hold


def test_percentiles_over_all_requests():
    values = [float(v) for v in range(1, 101)]
    assert stats.percentile(values, 50) == 50.0
    assert stats.percentile(values, 95) == 95.0
    # one slow request in twenty: p95 is the last fast one, not a mean of chunks
    lat = [1.0] * 95 + [9.0] * 5
    assert stats.percentile(lat, 95) == 1.0
    assert stats.percentile(lat + [9.0], 95) == 9.0
    assert stats.percentile([3.0], 95) == 3.0


def _run(kind, **kw):
    cell = SimpleNamespace(name="x")
    base = dict(cell=cell, kind=kind, h=2048, w=2048, setup_s=1.5, window=Window(),
                device_kind="NVIDIA H100 80GB HBM3", traced=None, report=None, new_psfs=0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_window_rate_and_readers():
    win = Window(requests=10, frames=80, seconds=0.5)
    run = _run("batch", window=win)
    assert spec.reader("mpix_per_s")(run) == pytest.approx(80 * 2048 * 2048 / 1e6 / 0.5)
    assert spec.reader("frame_ms_p50")(run) is None  # a batch run has no latencies
    stream = _run("stream", window=Window(requests=4, frames=4, latency_ms=[1.0, 2.0, 3.0, 4.0],
                                          dispatch_s=[0.001, 0.003]))
    assert spec.reader("frame_ms_p50")(stream) == 2.0
    assert spec.reader("frame_ms_p95")(stream) == 4.0
    assert spec.reader("frame_ms_p95.psf_per_frame")(stream) == 4.0
    assert spec.reader("dispatch_ms.stream")(stream) == pytest.approx(2.0)
    assert spec.reader("setup_s")(stream) == 1.5


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def test_idle_share_from_union_of_overlapping_rows():
    events = [
        _x(trace.SLICE, "user_annotation", 0, 100),
        _x("fphase_fft_psf", "user_annotation", 1, 4),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=7),
        _x("cudaLaunchKernel", "cuda_runtime", 8, 1, correlation=8),
        _x("cudaEventSynchronize", "cuda_runtime", 45, 14),
        # two streams overlapping on [20, 30]: busy counts it once
        _x("k_a", "kernel", 10, 20, tid=7, correlation=7),
        _x("k_b", "kernel", 20, 20, tid=8, correlation=8),
        _x("k_a", "kernel", 60, 10, tid=7),
        _x(trace.SLICE, "gpu_user_annotation", 0, 200, tid=7),
    ]
    rep = trace.reduce(events)
    assert rep.busy_s == pytest.approx(40e-6)
    assert rep.window_s == pytest.approx(100e-6)
    assert rep.ops_s == pytest.approx({"k_a": 30e-6, "k_b": 20e-6})
    assert rep.phases_s == pytest.approx({"fft_psf": 20e-6, "unattributed": 30e-6})
    # gaps [0, 10], [40, 60], [70, 100]: the host was in the sync during the middle one
    assert rep.gaps_s["cudaEventSynchronize"] == pytest.approx(20e-6)
    assert sum(rep.gaps_s.values()) == pytest.approx(60e-6)
    # 40 us busy a traced request; 20 requests in a 1 ms window: 80% busy
    run = _run("stream", report=rep, traced=Window(requests=1, frames=1),
               window=Window(requests=20, frames=20, seconds=1e-3))
    assert spec.reader("device_idle_share.stream")(run) == pytest.approx(20.0)
    assert spec.reader("psf_device_ms")(run) == pytest.approx(0.02)


@pytest.mark.parametrize("cell,frames,calls,ops,data", [
    # 2048^2 batch8: 8 frames x 3 channels x (forward + inverse) x half a complex transform
    ("photo_2048x2048_wiener.batch8", 8, 1, 8 * 3 * 5.0 * 2048**2 * 22,
     8 * 2 * 2048 * 2048 * 3 + 8 * 2048**2),
    # 3840x2160 at 4096^2: one frame a call
    ("uhd_3840x2160_wiener.stream", 1, 1, 3 * 5.0 * 4096**2 * 24,
     2 * 3840 * 2160 * 3 + 8 * 4096**2),
    ("uhd_3840x2160_wiener.batch4", 4, 1, 4 * 3 * 5.0 * 4096**2 * 24,
     4 * 2 * 3840 * 2160 * 3 + 8 * 4096**2),
])
def test_roofline_counts_at_cell_shapes(cell, frames, calls, ops, data):
    c = spec.load_cell(cell)
    h, w = c.config["frame"]["height"], c.config["frame"]["width"]
    assert counts.padded(h, w) == c.config["padded"][0] * c.config["padded"][1]
    got = counts.restore_work(h, w, frames, calls)
    assert got == (pytest.approx(ops), data)
    t, bound = counts.least_time(*got, "NVIDIA H100 80GB HBM3")
    assert bound == "compute" and t == pytest.approx(ops / 67e12)
    assert counts.least_time(*got, "some other card") is None


def test_roofline_share_counts_new_psfs():
    rep = trace.TraceReport(busy_s=2e-3, window_s=2.2e-3)
    run = _run("stream", h=2160, w=3840, report=rep, traced=Window(requests=1, frames=1),
               new_psfs=1)
    ops = 3 * 5.0 * 4096**2 * 24 + 0.5 * 5.0 * 4096**2 * 24
    assert spec.reader("restore_roofline.psf_per_frame")(run) == pytest.approx(
        ops / 67e12 / 2e-3 * 100)
    run.report = trace.TraceReport(busy_s=0.0, window_s=1.0)
    assert spec.reader("restore_roofline.stream")(run) is None  # never 0


def test_schedule_same_lengths_every_seed():
    traffic = {"psf": {"mode": "per_request", "length": [20, 60], "angle": [0.0, 180.0]}}
    cfg = {"psf": {"length": 50, "angle": 30.0}}
    a, b = Schedule(traffic, cfg, SEED), Schedule(traffic, cfg, 5)
    la = sorted(a(i)[0] for i in range(82))
    assert la == sorted(b(i)[0] for i in range(82)) == sorted(list(range(20, 61)) * 2)
    assert [a(i) for i in range(5)] == [Schedule(traffic, cfg, SEED)(i) for i in range(5)]
    assert len({a(i)[1] for i in range(82)}) == 82
    assert Schedule({"psf": {"mode": "fixed"}}, cfg, 1)(9) == (50, 30.0)


def test_sampler_keeps_a_seeded_sample_and_the_last():
    s = Sampler(3, SEED)
    for i in range(100):
        s.offer(i, None, i)
    items = s.items()
    assert len(items) == 4 and items[-1][0] == 99
    t = Sampler(3, SEED)
    for i in range(100):
        t.offer(i, None, i)
    assert [x[0] for x in t.items()] == [x[0] for x in items]


def test_new_files_are_found_without_edits(tmp_path, bench_tree):
    before = {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    bench = bench_tree / "benchmark"
    (bench / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return float(run.window.frames)\n")
    spec_json = json.loads((bench_tree / "BENCHMARK.json").read_text())
    spec_json["per_layer"].append(dict(name="frames_done", unit="frames", better="higher",
                                       source="program_counter", layer="pipelines",
                                       moves="mpix_per_s",
                                       workloads=[f"{TINY}.tiny_batch"]))
    (bench_tree / "BENCHMARK.json").write_text(json.dumps(spec_json))
    cell = spec.load_cell(f"{TINY}.tiny_batch", root=bench_tree, bench_dir=bench)
    assert cell.config["frame"]["height"] == 80 and cell.traffic["stack"] == 3
    assert "frames_done" in [m["name"] for m in cell.per_layer]
    run, checked = harness.run_cell(cell, SEED, 0.2, True, device="cpu")
    line = harness.result_line(run, checked, True)
    assert line["metrics"]["frames_done"]["value"] == run.window.frames
    after = {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert after == before


@pytest.mark.parametrize("traffic", ["tiny_stream", "tiny_stream_psf", "tiny_batch"])
def test_small_cell_runs_right(bench_tree, traffic):
    cell = spec.load_cell(f"{TINY}.{traffic}", root=bench_tree,
                          bench_dir=bench_tree / "benchmark")
    run, checked = harness.run_cell(cell, SEED, 0.2, False, device="cpu")
    line = harness.result_line(run, checked, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert line["compared"]["worst_off_share"]["limit"] == cell.limits["worst_off_share"]
    assert checked["numbers"]["max_off"] <= 1
    # the same seed makes the same inputs
    assert torch.equal(harness.make_inputs(cell, SEED, "cpu"), harness.make_inputs(cell, SEED,
                                                                                  "cpu"))


def test_traced_line_has_breakdown(bench_tree):
    cell = spec.load_cell(f"{TINY}.tiny_stream_psf", root=bench_tree,
                          bench_dir=bench_tree / "benchmark")
    run, checked = harness.run_cell(cell, SEED, 0.2, True, device="cpu")
    line = harness.result_line(run, checked, True)
    assert list(line)[-2:] == ["breakdown", "compared"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert run.new_psfs == run.traced.requests  # every traced request a new PSF
    assert {"dispatch_ms.psf_per_frame", "frame_ms_p50.psf_per_frame"} <= {
        m["name"] for m in cell.per_layer + cell.end_to_end}
    assert "dispatch_ms.psf_per_frame" in line["metrics"]
    # a CPU run has no device time: no roofline share or idle share is read
    assert not any(k.startswith(("restore_roofline", "device_idle")) for k in line["metrics"])


class Unchanged:
    """A step that returns its state unchanged: the input frame as output."""

    def __init__(self, pipe):
        self.pipe = pipe

    def run(self, x, length, angle, K):
        return x, None


class HalfBatch(Unchanged):
    """Half of each stack left out: those frames come back zero."""

    def run(self, x, length, angle, K):
        half = x.shape[0] // 2
        out, _ = self.pipe.run(x[:half], length, angle, K)
        return torch.cat([out, torch.zeros_like(x[half:])]), None


class Altered(Unchanged):
    """An answer altered where it is produced: every value of the output
    one count up (255 stays)."""

    def run(self, x, length, angle, K):
        out, planes = self.pipe.run(x, length, angle, K)
        return torch.where(out < 255, out + 1, out), planes


@pytest.mark.parametrize("traffic,fault", [
    ("tiny_stream", Unchanged), ("tiny_stream", Altered),
    ("tiny_stream_psf", Unchanged), ("tiny_stream_psf", Altered),
    ("tiny_batch", Unchanged), ("tiny_batch", HalfBatch), ("tiny_batch", Altered),
])
def test_planted_faults_fail(bench_tree, traffic, fault):
    cell = spec.load_cell(f"{TINY}.{traffic}", root=bench_tree,
                          bench_dir=bench_tree / "benchmark")
    run, checked = harness.run_cell(cell, SEED, 0.2, False, device="cpu", wrap=fault)
    line = harness.result_line(run, checked, False)
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("traffic", ["tiny_stream", "tiny_batch"])
def test_control_fails(bench_tree, traffic):
    """bf16 staging, the precision below the configuration's, is not correct."""
    cell = spec.load_cell(f"{TINY}.{traffic}", root=bench_tree,
                          bench_dir=bench_tree / "benchmark")
    _, checked = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                                  over={"stage_dtype": "bf16"})
    assert checked["correct"] is False
    assert checked["numbers"]["worst_off_share"] > 3 * cell.limits["worst_off_share"]


def test_run_without_a_card_exits_nonzero():
    res = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "photo_2048x2048_wiener.batch8", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    if res.returncode == 0:
        pytest.fail("run.py exited 0 without a CUDA device")
    assert "{" not in res.stdout
