"""The per-layer metrics that read the program's own spans and counters
(benchmark/program_spans.py) on the small cells on the CPU: the traced
slice's make_psf host ms, PSF-cache miss share and the request's self
time; two traced runs in one process, each read right after it; and
what a program without the records, or with fewer of the slice's
requests than it ran, gives."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans, spec
from benchmark.tests.conftest import TINY
from benchmark.traffic import Window

SEED = 2**31 + 24681357


def _traced(bench_tree, traffic):
    cell = spec.load_cell(f"{TINY}.{traffic}", root=bench_tree,
                          bench_dir=bench_tree / "benchmark")
    run, checked = harness.run_cell(cell, SEED, 0.2, True, device="cpu")
    return run, harness.result_line(run, checked, True)


def test_psf_cell_reads_make_psf_and_misses(bench_tree):
    run, line = _traced(bench_tree, "tiny_stream_psf")
    metrics = line["metrics"]
    assert metrics["make_psf_host_ms"]["value"] > 0
    assert metrics["psf_cache_miss_share"]["value"] == 100.0
    assert "make_psf_device_ms" not in metrics  # a CPU trace has no device rows
    assert "run_self_host_ms.stream" not in metrics  # the cached stream's alone


def test_stream_cell_reads_the_requests_self_time(bench_tree):
    run, line = _traced(bench_tree, "tiny_stream")
    own = line["metrics"]["run_self_host_ms.stream"]["value"]
    snap = program_spans.slice_snapshot(run)
    assert 0 < own < snap.host_ms["frequest"] / snap.requests
    assert "make_psf_host_ms" not in line["metrics"]


def test_two_traced_runs_read_their_own_requests(bench_tree):
    """The per-frame PSF cell, then the cached stream, in one process:
    each read right after its run sees its own slice (all misses, then
    none)."""
    psf_run, _ = _traced(bench_tree, "tiny_stream_psf")
    first = program_spans.slice_snapshot(psf_run)
    assert program_spans.psf_cache_miss_share(psf_run) == 100.0
    stream_run, _ = _traced(bench_tree, "tiny_stream")
    second = program_spans.slice_snapshot(stream_run)
    assert program_spans.psf_cache_miss_share(stream_run) == 0.0
    assert program_spans.make_psf_host_ms(stream_run) == 0.0
    ids = lambda snap: {s.request for s in snap.spans}  # noqa: E731
    assert min(ids(second)) > max(ids(first))
    assert second.requests == stream_run.traced.requests


def test_a_program_without_records_gives_none(monkeypatch):
    from fft_restoration_tpu_torch.utils import trace_profile

    monkeypatch.delattr(trace_profile, "snapshot")
    run = SimpleNamespace(traced=Window(requests=2, frames=2), report=None)
    for read in (program_spans.make_psf_host_ms, program_spans.run_self_host_ms,
                 program_spans.psf_cache_miss_share, program_spans.make_psf_device_ms):
        assert read(run) is None
    untraced = SimpleNamespace(traced=None, report=None)
    assert program_spans.slice_snapshot(untraced) is None


def test_fewer_recorded_requests_than_the_slice_ran_raise(monkeypatch):
    from fft_restoration_tpu_torch.utils import trace_profile

    monkeypatch.setattr(trace_profile, "RECORDER", trace_profile.Recorder())
    run = SimpleNamespace(traced=Window(requests=3, frames=3), report=None)
    with pytest.raises(RuntimeError, match="recorded 0 of the traced slice's 3 requests"):
        program_spans.make_psf_host_ms(run)
