"""The port's in-memory spans and counters (utils/trace_profile.py):
nothing kept while no profiler records; under one, a `frequest` record
for each pipeline request, with the `fphase_` records of its make_psf,
fft_psf and restore phases carrying its id, nested in its interval
under the right parent; each record inside its range of the exported
chrome trace; the PSF cache's lookups, misses and evictions; the ring's
bound and drop count; self time; and the recorder under many threads.
Every test records into a fresh Recorder of its own."""

import json
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline
from fft_restoration_tpu_torch.models.pipeline import PSF_CACHE_SIZE
from fft_restoration_tpu_torch.utils import trace_profile as tp

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

H, W, L, K = 24, 40, 5, 0.01
RESTORE = {"fphase_fft_image", "fphase_spectral_fused", "fphase_ifft", "fphase_post_process"}


@pytest.fixture
def rec(monkeypatch):
    fresh = tp.Recorder()
    monkeypatch.setattr(tp, "RECORDER", fresh)
    return fresh


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _by_request(spans):
    out = defaultdict(list)
    for s in spans:
        out[s.request].append(s)
    return out


def test_tracing_off_keeps_nothing(rec):
    assert not torch.autograd._profiler_enabled()
    pipe = WienerDeblurPipeline("cpu", emit_planes=False)
    x = _frame()
    for angle in range(PSF_CACHE_SIZE + 2):  # misses and an eviction, untraced
        pipe.run(x, L, float(angle), K)
    BatchedWienerPipeline("cpu", emit_planes=False).run(x[None], L, 1.0, K)
    snap = tp.snapshot()
    assert snap.spans == [] and snap.counters == {} and snap.requests == 0
    assert rec.counters == {} and rec.dropped == 0
    assert tp.frequest(1) is tp.fphase("make_psf")  # the one shared null context


def test_traced_request_records_every_range(rec):
    pipe = WienerDeblurPipeline("cpu", emit_planes=False)
    x = _frame()
    pipe.run(x, L, 30.0, K)  # untraced: the PSF is cached
    _traced(lambda: (pipe.run(x, L, 30.0, K), pipe.run(x, L, 45.0, K)))
    snap = tp.snapshot()
    assert snap.requests == 2
    cached, new = (sorted(s.name for s in spans) for _, spans in
                   sorted(_by_request(snap.spans).items()))
    assert set(cached) == {"frequest"} | RESTORE
    assert set(new) == {"frequest", "fphase_make_psf", "fphase_fft_psf"} | RESTORE
    assert set(snap.host_ms) == set(new)
    assert all(s.end_ns > s.start_ns for s in snap.spans)


@pytest.mark.parametrize("backend,psf_parent", [("pallas", "frequest"),
                                                ("matmul", "fphase_pre_process")])
def test_request_ids_nest_their_spans(rec, backend, psf_parent):
    """Request k: each of its spans carries id k, lies inside k's
    interval, and has the span that opened it as parent (make_psf under
    the request on the kernel route, under pre_process on the generic)."""
    pipe = WienerDeblurPipeline("cpu", emit_planes=False, fft_backend=backend)
    x = _frame()
    _traced(lambda: [pipe.run(x, L, float(a), K) for a in (10, 20, 30)])
    snap = tp.snapshot()
    by_id = {s.id: s for s in snap.spans}
    requests = sorted((s for s in snap.spans if s.name == tp.REQUEST), key=lambda s: s.request)
    assert [r.request for r in requests] == list(range(3)) and all(r.frames == 1
                                                                     for r in requests)
    for req in requests:
        assert req.parent is None
        mine = [s for s in snap.spans if s.request == req.request]
        assert len(mine) > 1
        for s in mine:
            assert req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns
            if s is not req:
                parent = by_id[s.parent]
                assert parent.request == req.request
                assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
        make_psf = [s for s in mine if s.name == "fphase_make_psf"]
        assert len(make_psf) == 1 and by_id[make_psf[0].parent].name == psf_parent


def test_batched_request_counts_its_frames(rec):
    pipe = BatchedWienerPipeline("cpu", emit_planes=False)
    stack = torch.stack([_frame(1), _frame(2), _frame(3)])
    _traced(lambda: pipe.run(stack, L, 30.0, K))
    req, = [s for s in tp.snapshot().spans if s.name == tp.REQUEST]
    assert req.frames == 3 and req.counters == {"psf_lookups": 1, "psf_misses": 1}


def _record_gaps(pipe, x, angle, path):
    """One traced session of two requests, the second with a new PSF at
    `angle`. For each record, paired with its same-named user_annotation
    range of the exported trace in order of start (ts: the wall clock in
    us less baseTimeNanoseconds): (name, us from the range's start to the
    record's, us from the record's end to the range's, whether the range
    opened first in the session, whether it closed first)."""
    prof = _traced(lambda: (pipe.run(x, L, 30.0, K), pipe.run(x, L, angle, K)))
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    first_open = min(lo for rs in ranges.values() for lo, _ in rs)
    first_close = min(hi for rs in ranges.values() for _, hi in rs)
    spans = tp.snapshot(last_requests=2).spans
    assert {s.name for s in spans} == set(ranges) and len(spans) >= 15
    gaps = []
    for name, rs in ranges.items():
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        assert len(mine) == len(rs), name
        for span, (lo, hi) in zip(mine, sorted(rs)):
            gaps.append((name, (span.start_ns - base) / 1e3 - lo,
                         hi - (span.end_ns - base) / 1e3, lo == first_open, hi == first_close))
    return gaps


def test_records_lie_inside_their_trace_ranges(rec, tmp_path):
    """Each record lies inside its range of the exported trace within 20
    us, and within 0.1 ms of it at both ends, but for the session's first
    range to open and first to close: at a session's first entry and
    first exit the profiler's own first-call cost (up to ~1 ms in a
    process's first session, which a session before the measured one
    takes) falls between them. The closeness is a time on a shared CPU:
    a session in which the thread lost its core between the profiler's
    clock read and the record's is traced again, up to three sessions;
    the record lies inside its range in each."""
    pipe = WienerDeblurPipeline("cpu", emit_planes=False)
    x = _frame()
    _traced(lambda: pipe.run(x, L, 30.0, K))
    for attempt in range(3):
        gaps = _record_gaps(pipe, x, 60.0 + attempt, tmp_path / f"trace{attempt}.json")
        for name, start, end, _, _ in gaps:
            assert start >= -20 and end >= -20, (name, start, end)
        far = [(name, start, end) for name, start, end, opened, closed in gaps
               if (start >= 100 and not opened) or (end >= 100 and not closed)]
        if not far:
            break
    assert not far, far


def test_psf_cache_counts_miss_hit_and_eviction(rec):
    pipe = WienerDeblurPipeline("cpu", emit_planes=False)
    x = _frame()
    angles = [30.0, 30.0] + [float(a) for a in range(PSF_CACHE_SIZE)]
    _traced(lambda: [pipe.run(x, L, a, K) for a in angles])
    requests = sorted((s for s in tp.snapshot().spans if s.name == tp.REQUEST),
                      key=lambda s: s.request)
    counts = [r.counters for r in requests]
    assert counts[0] == {"psf_lookups": 1, "psf_misses": 1}
    assert counts[1] == {"psf_lookups": 1}
    assert counts[2:-1] == [{"psf_lookups": 1, "psf_misses": 1}] * (PSF_CACHE_SIZE - 1)
    assert counts[-1] == {"psf_lookups": 1, "psf_misses": 1, "psf_evictions": 1}
    total = {"psf_lookups": len(angles), "psf_misses": len(angles) - 1, "psf_evictions": 1}
    assert tp.snapshot().counters == rec.counters == total
    assert tp.snapshot(last_requests=2).counters == {"psf_lookups": 2, "psf_misses": 2,
                                                     "psf_evictions": 1}


def test_ring_keeps_whole_latest_requests_and_counts_drops(monkeypatch):
    rec = tp.Recorder(capacity=20)
    monkeypatch.setattr(tp, "RECORDER", rec)
    pipe = WienerDeblurPipeline("cpu", emit_planes=False)
    x = _frame()
    pipe.run(x, L, 30.0, K)
    n = 7
    _traced(lambda: [pipe.run(x, L, 30.0, K) for _ in range(n)])
    per_request = 1 + len(RESTORE) + 2  # ifft and post_process open twice
    snap = tp.snapshot()
    kept = len(snap.spans)
    assert kept <= 20 and kept % per_request == 0
    assert snap.dropped == n * per_request - kept
    assert sorted({s.request for s in snap.spans}) == list(range(n - kept // per_request, n))
    assert snap.requests == kept // per_request
    assert tp.snapshot(last_requests=1).requests == 1
    assert tp.snapshot(last_requests=0).spans == []


def test_self_time_is_duration_less_child_spans(rec):
    pipe = WienerDeblurPipeline("cpu", emit_planes=False)
    x = _frame()
    _traced(lambda: [pipe.run(x, L, a, K) for a in (30.0, 30.0, 50.0)])
    snap = tp.snapshot()
    for req in (s for s in snap.spans if s.name == tp.REQUEST):
        children = [s for s in snap.spans if s.parent == req.id]
        assert children and req.child_ns == sum(c.end_ns - c.start_ns for c in children)
        assert req.self_ns == req.end_ns - req.start_ns - req.child_ns > 0
    phases = sum(ms for name, ms in snap.host_ms.items() if name != tp.REQUEST)
    assert snap.self_ms[tp.REQUEST] == pytest.approx(snap.host_ms[tp.REQUEST] - phases)
    leaves = {k: v for k, v in snap.self_ms.items() if k != tp.REQUEST}
    assert leaves == pytest.approx({k: snap.host_ms[k] for k in leaves})


def test_recorder_under_many_threads():
    """More threads than cores opening nested spans and counting, with a
    short switch interval: no count lost, every span kept once, each
    span's parent on its own thread and request."""
    rec = tp.Recorder(capacity=10_000)
    n_threads, n_requests = 16, 50

    def work():
        for _ in range(n_requests):
            req = rec.open(tp.REQUEST, time.time_ns(), 1)
            for phase in ("a", "b"):
                span = rec.open(phase, time.time_ns())
                rec.count("psf_lookups")
                rec.close(span, time.time_ns())
            rec.close(req, time.time_ns())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = rec.snapshot()
    total = n_threads * n_requests
    assert rec.counters == {"psf_lookups": 2 * total}
    assert snap.requests == total and len(snap.spans) == 3 * total and snap.dropped == 0
    assert len({s.id for s in snap.spans}) == 3 * total
    by_id = {s.id: s for s in snap.spans}
    for s in snap.spans:
        if s.name == tp.REQUEST:
            assert s.counters == {"psf_lookups": 2} and s.child_ns <= s.end_ns - s.start_ns
        else:
            assert by_id[s.parent].name == tp.REQUEST and by_id[s.parent].request == s.request


RL_ITERS = 3


@pytest.mark.parametrize("backend", ["pallas", "matmul"])
def test_rl_request_records_each_iteration_and_convolution(rec, backend):
    """An RL request: rl_iters `fphase_rl_iteration` records under its
    request span, two `fphase_rl_conv` records under each, every one in
    its parent's interval, and the counts rl_iterations and rl_convs on
    the request; a Wiener request of the same session records none."""
    rl = WienerDeblurPipeline("cpu", emit_planes=False, fft_backend=backend, filter_name="rl",
                              rl_iters=RL_ITERS)
    wiener = WienerDeblurPipeline("cpu", emit_planes=False, fft_backend=backend)
    x = _frame()
    rl.run(x, L, 30.0, K)  # untraced: the PSF is cached
    wiener.run(x, L, 30.0, K)
    _traced(lambda: (rl.run(x, L, 30.0, K), rl.run(x, L, 30.0, K), wiener.run(x, L, 30.0, K)))
    snap = tp.snapshot()
    by_id = {s.id: s for s in snap.spans}
    (*rl_ids, wiener_id), = [sorted(_by_request(snap.spans))]
    for request in rl_ids:
        mine = _by_request(snap.spans)[request]
        req, = [s for s in mine if s.name == tp.REQUEST]
        iterations = [s for s in mine if s.name == "fphase_rl_iteration"]
        convs = [s for s in mine if s.name == "fphase_rl_conv"]
        assert len(iterations) == RL_ITERS and len(convs) == 2 * RL_ITERS
        assert all(by_id[s.parent] is req for s in iterations)
        assert sorted(by_id[s.parent].id for s in convs) == sorted(
            2 * [s.id for s in iterations])
        for s in iterations + convs:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        rl_counts = {k: v for k, v in req.counters.items() if k.startswith("rl_")}
        assert rl_counts == {"rl_iterations": RL_ITERS, "rl_convs": 2 * RL_ITERS}
    wiener_spans = _by_request(snap.spans)[wiener_id]
    assert not any(s.name.startswith("fphase_rl_") for s in wiener_spans)
    req, = [s for s in wiener_spans if s.name == tp.REQUEST]
    assert not any(k.startswith("rl_") for k in req.counters)


def test_hundred_rl_requests_fit_the_ring(rec):
    """The benchmark's traced slice of the RL stream: 100 requests at 10
    iterations, 33 records each (request, pre_process, 10 iterations, 20
    convolutions, post_process), all kept by the ring whole."""
    pipe = WienerDeblurPipeline("cpu", emit_planes=False, filter_name="rl", rl_iters=10)
    x = _frame()
    pipe.run(x, L, 30.0, K)
    _traced(lambda: [pipe.run(x, L, 30.0, K) for _ in range(100)])
    snap = tp.snapshot(last_requests=100)
    assert rec.capacity == tp.RING_SPANS and snap.dropped == 0
    assert snap.requests == 100 and len(snap.spans) == 100 * 33 <= tp.RING_SPANS
    assert snap.counters == {"psf_lookups": 100, "rl_iterations": 1000, "rl_convs": 2000}
