"""The port's device-timeline profiler (utils/trace_profile.py), the twin
of tests/test_trace_profile.py: the device-row filter and the phase
breakdown on a synthetic trace in torch's chrome-trace format (kernels
launched inside and outside fphase_ ranges, through each attribution
route), device busy as the union of overlapping rows, the report's text
(the spans' host ms and the PSF-cache counts included), and device_trace
of a CPU function, which has no device rows and reports "not measured",
and of a pipeline, whose traced runs' spans it reads."""

import json
from collections import Counter

import pytest
import torch

from fft_restoration_tpu_torch.utils import trace_profile as tp

HOST, DEV, TID, STREAM = 4242, 0, 4242, 7


def _ann(name, ts, dur, ext):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": HOST, "tid": TID,
            "ts": ts, "dur": dur, "args": {"External id": ext}}


def _launch(ts, corr, ext, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "pid": HOST, "tid": TID,
            "ts": ts, "dur": 3, "args": {"correlation": corr, "External id": ext}}


def _kernel(name, ts, dur, corr, ext=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": DEV, "tid": STREAM, "ts": ts,
            "dur": dur, "args": {"correlation": corr, "External id": ext, "stream": STREAM}}


def _trace():
    """Two iterations of a restore: B1 under fft_image, B2 under
    spectral_fused, B3 under ifft (nested in an outer pre_process range:
    the innermost wins), a fill under post_process found through the
    driver call, a kernel whose launch was not traced (inside a
    device-side annotation span, which places nothing), a copy launched
    outside every range, and host events that must not count."""
    ev = [{"ph": "M", "name": "process_name", "pid": HOST, "args": {"name": "python"}}]
    for it in range(2):
        t = 1000.0 * it
        ev += [
            _ann("fphase_fft_image", t, 50, 10 + it),
            _launch(t + 5, 100 + it, 10 + it),
            _kernel("fft_rows_t_kernel", t + 100, 90, 100 + it),
            _ann("fphase_spectral_fused", t + 60, 40, 20 + it),
            _launch(t + 65, 200 + it, 20 + it),
            _kernel("spectral_s_kernel", t + 190, 137, 200 + it),
            _ann("fphase_pre_process", t + 101, 100, 30 + it),
            _ann("fphase_ifft", t + 110, 30, 40 + it),
            _launch(t + 115, 300 + it, 40 + it),
            _kernel("fft_rows_kernel", t + 330, 70, 300 + it),
            _ann("fphase_post_process", t + 210, 60, 50 + it),
            _launch(t + 215, 400 + it, 50 + it, cat="cuda_driver"),
            _kernel("Memset (Device)", t + 400, 4, 400 + it, cat="gpu_memset"),
            {"ph": "X", "cat": "gpu_user_annotation", "name": "fphase_post_process",
             "pid": DEV, "tid": STREAM, "ts": t + 404, "dur": 40, "args": {}},
            _kernel("wb_encode_kernel", t + 410, 30, 999 + it),  # launch not traced
            _launch(t + 300, 500 + it, 0),  # outside every range
            _kernel("Memcpy DtoD (Device -> Device)", t + 450, 10, 500 + it, cat="gpu_memcpy"),
            {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": HOST, "tid": TID,
             "ts": t + 299, "dur": 9, "args": {"External id": 60 + it}},
            {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": HOST, "tid": TID, "ts": t + 5,
             "id": 100 + it},
        ]
    return ev


def test_device_rows_keep_kernels_copies_fills_only():
    rows = tp.device_rows(_trace())
    assert sorted({r["name"] for r in rows}) == sorted(
        ["fft_rows_t_kernel", "spectral_s_kernel", "fft_rows_kernel", "Memset (Device)",
         "wb_encode_kernel", "Memcpy DtoD (Device -> Device)"])
    assert len(rows) == 12 and all(r["pid"] == DEV for r in rows)


def test_phase_breakdown_assigns_the_innermost_range():
    phases = tp.phase_breakdown(_trace(), n_iters=2)
    assert phases == pytest.approx({
        "fft_image": 0.090, "spectral_fused": 0.137, "ifft": 0.070,
        "post_process": 0.004, "unattributed": 0.040})
    assert sum(phases.values()) == pytest.approx(
        sum(r["dur"] for r in tp.device_rows(_trace())) / 1e3 / 2)
    placed = Counter((row["name"], phase) for row, phase in tp.attribute(_trace()))
    assert placed[("wb_encode_kernel", "unattributed")] == 2
    assert placed[("Memcpy DtoD (Device -> Device)", "unattributed")] == 2
    assert sum(placed.values()) == 12


def test_report_formats():
    rep = tp.DeviceTraceReport(n_iters=10, device_total_ms=0.4, device_span_ms=0.7,
                               ops_ms={"spectral_s_kernel": 1.37, "fft_rows_kernel": 0.7},
                               trace_dir="/tmp/x", phases_ms={"spectral_fused": 0.137})
    text = rep.report()
    assert "0.400 ms/iter" in text and "0.700 ms/iter" in text
    assert "spectral_s_kernel" in text and "spectral_fused" in text
    empty = tp.DeviceTraceReport(n_iters=2, device_total_ms=0.0, device_span_ms=0.0)
    assert "not measured" in empty.report() and "ms/iter" not in empty.report()


def test_device_trace_cpu_reports_not_measured(tmp_path):
    x = torch.ones(64, 64)

    def fn(a):
        with tp.fphase("fft_image"):
            return a * 2.0

    rep = tp.device_trace(fn, (x,), n_iters=2, trace_dir=str(tmp_path / "tr"))
    assert rep.n_iters == 2
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU function's trace holds CUDA activity")
    assert rep.device_total_ms == 0.0 and rep.device_span_ms == 0.0
    assert rep.ops_ms == {} and rep.phases_ms == {}
    assert "not measured" in rep.report()
    # the kept trace holds the host-side range the function opened
    events = tp.load_trace(str(tmp_path / "tr" / "trace.json"))
    assert any(e.get("name") == "fphase_fft_image" and e.get("cat") == "user_annotation"
               for e in events)
    json.dumps(events)


def test_fphase_is_a_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert tp.fphase("ifft") is tp.fphase("fft_image")  # one shared null context
    with tp.fphase("ifft"):
        pass


def test_profile_paths_reads_device_time_through_device_trace():
    """tools/profile_paths.py reads device time through device_trace: a
    CPU run has no device rows."""
    from fft_restoration_tpu_torch.tools import profile_paths

    assert profile_paths.device_trace is tp.device_trace
    rep = profile_paths.device_trace(lambda: torch.ones(8) * 2, (), n_iters=2)
    assert isinstance(rep, tp.DeviceTraceReport) and rep.n_iters == 2
    if not torch.cuda.is_available():
        assert rep.device_total_ms == 0.0 and "not measured" in rep.report()


def test_device_busy_is_the_union_of_overlapping_rows():
    """Rows of two streams overlapping on [20, 30], a third inside both,
    and a gap: busy counts each instant once, 40 us where the rows sum to
    55."""
    rows = [_kernel("a", 10, 20, 1), _kernel("b", 20, 20, 2), _kernel("c", 22, 5, 3),
            _kernel("d", 60, 10, 4)]
    assert tp.busy_us(rows) == pytest.approx(40.0)
    assert sum(r["dur"] for r in rows) == 55
    assert tp.busy_us(tp.device_rows(_trace())) == pytest.approx(
        sum(r["dur"] for r in tp.device_rows(_trace())))  # one stream, no overlap
    assert tp.busy_us([]) == 0.0


def test_report_prints_spans_and_counters():
    rep = tp.DeviceTraceReport(n_iters=2, device_total_ms=0.4, device_span_ms=0.7,
                               ops_ms={"k": 0.8},
                               spans_ms={"frequest": (1.5, 0.25), "fphase_ifft": (0.5, 0.5)},
                               counters={"psf_lookups": 2, "psf_misses": 1})
    lines = rep.report().splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("  spans (host ms a run"))
    assert lines[i + 1].split() == ["1.500", "ms", "0.250", "ms", "frequest"]
    assert lines[i + 2].split() == ["0.500", "ms", "0.500", "ms", "fphase_ifft"]
    assert lines[-1] == "  PSF cache: psf_lookups 2, psf_misses 1"
    cpu = tp.DeviceTraceReport(n_iters=2, device_total_ms=0.0, device_span_ms=0.0,
                               spans_ms={"frequest": (1.5, 0.25)})
    text = cpu.report()
    assert "not measured" in text and "frequest" in text and "ms/iter" not in text


def test_device_trace_reads_the_traced_runs_spans(monkeypatch):
    """device_trace's report holds the in-memory records of its traced
    runs alone: the warm-up call before the trace (a new PSF) is not
    recorded, each traced run is one request with a cache hit."""
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    monkeypatch.setattr(tp, "RECORDER", tp.Recorder())
    pipe = WienerDeblurPipeline("cpu", emit_planes=False)
    x = torch.zeros(24, 40, 3, dtype=torch.uint8)
    rep = tp.device_trace(pipe.run, (x, 5, 30.0, 0.01), n_iters=3)
    assert rep.counters == {"psf_lookups": 3}
    assert "fphase_make_psf" not in rep.spans_ms
    host, own = rep.spans_ms["frequest"]
    assert 0 < own < host
    assert set(rep.spans_ms) == {"frequest", "fphase_fft_image", "fphase_spectral_fused",
                                 "fphase_ifft", "fphase_post_process"}
    assert "PSF cache: psf_lookups 3" in rep.report()
