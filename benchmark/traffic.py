"""The general generator: the request schedule a traffic file describes,
and the closed loops that offer it to the program.

A traffic file (traffic/<name>.json) holds only parameters:

  kind          "stream": one client, one frame a request, each waited for
                before the next; "batch": stacks of `stack` frames, the
                host keeping up to `queued_ahead` stacks queued ahead
  pool          distinct frames ("stream") or stacks ("batch") to cycle
  psf           {"mode": "fixed"}: the configuration's PSF for every
                request; {"mode": "per_request", "length": [lo, hi],
                "angle": [lo, hi]}: each request its own PSF, every length
                of the range once in each run of (hi - lo + 1) requests,
                in an order and with angles drawn from the seed
  warmup        requests (or stacks) run before the window
  sample        requests (or stacks) of the window kept for the check
  trace_requests  requests (or stacks) in the traced slice (--trace 1)

The loops time each request (stream) or the window (batch) and record the
host's dispatch time of each `run` call; they never synchronise inside a
`run` call.
"""

from __future__ import annotations

import contextlib
import random
import time
from collections import deque
from dataclasses import dataclass, field

import torch


class Schedule:
    """The (length, angle) of request i, from the traffic's psf block and
    the configuration's PSF, drawn from the seed."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        psf = traffic["psf"]
        self.fixed = psf["mode"] == "fixed"
        self.default = (int(config["psf"]["length"]), float(config["psf"]["angle"]))
        if not self.fixed:
            if psf["mode"] != "per_request":
                raise ValueError(f"unknown psf mode {psf['mode']!r}")
            lo, hi = psf["length"]
            self.lengths = list(range(int(lo), int(hi) + 1))
            self.angles = tuple(float(a) for a in psf["angle"])
        self.seed = int(seed)
        self.rng = random.Random(f"schedule-{self.seed}")
        self.drawn = []

    def __call__(self, i: int) -> tuple:
        if self.fixed:
            return self.default
        while len(self.drawn) <= i:
            block = list(self.lengths)
            self.rng.shuffle(block)
            self.drawn += [(n, self.rng.uniform(*self.angles)) for n in block]
        return self.drawn[i]

    def warm_points(self) -> list:
        """One PSF of every length the schedule uses (angles apart from
        the window's): the shapes the warm-up has to see."""
        if self.fixed:
            return [self.default]
        rng = random.Random(f"warm-{self.seed}")
        return [(n, rng.uniform(*self.angles)) for n in self.lengths]


class Sampler:
    """A uniform sample, drawn from the seed, of the window's requests
    (reservoir sampling), and the last one: (index, what it was, output)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = random.Random(f"sample-{int(seed)}")
        self.kept = []
        self.last = None
        self.seen = 0

    def offer(self, index, what, out):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, what, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (index, what, out)
        self.last = (index, what, out)

    def items(self) -> list:
        out = sorted(self.kept, key=lambda x: x[0])
        if self.last is not None and all(x[0] != self.last[0] for x in out):
            out.append(self.last)
        return out


class CudaClock:
    """Request times on the device's clock: CUDA events on the stream."""

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def begin(self):
        self.start.record()

    def finish(self) -> float:
        """Wait for the request; its ms from begin() to its last operation."""
        self.end.record()
        self.end.synchronize()
        return self.start.elapsed_time(self.end)

    @staticmethod
    def fence():
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def sync():
        torch.cuda.synchronize()


class HostClock:
    """The same interface on the host clock, for runs on the CPU (tests)."""

    def begin(self):
        self.t0 = time.perf_counter()

    def finish(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    @staticmethod
    def fence():
        return None

    @staticmethod
    def sync():
        pass


@dataclass
class Window:
    """What a loop measured: requests (or stacks) offered, frames done,
    per-request latency ms (stream), dispatch seconds of each `run` call,
    the window's host seconds, and the PSFs it used."""

    requests: int = 0
    frames: int = 0
    latency_ms: list = field(default_factory=list)
    dispatch_s: list = field(default_factory=list)
    seconds: float = 0.0
    psfs: list = field(default_factory=list)


def stream_loop(pipe, pool, schedule, K, clock, *, seconds=None, count=None, start=0,
                sampler=None, on_request=None) -> Window:
    """One client: each request waits for the one before. Runs `count`
    requests, or until `seconds` have passed."""
    win = Window()
    t0 = time.perf_counter()
    t_end = t0 + (seconds if seconds is not None else float("inf"))
    i = start
    while (count is None or win.requests < count) and time.perf_counter() < t_end:
        frame = i % len(pool)
        length, angle = schedule(i)
        with (on_request or contextlib.nullcontext)():
            clock.begin()
            d0 = time.perf_counter()
            out, _ = pipe.run(pool[frame], length, angle, K)
            win.dispatch_s.append(time.perf_counter() - d0)
            win.latency_ms.append(clock.finish())
        if sampler is not None:
            sampler.offer(i, (frame, length, angle), out)
        win.psfs.append((length, angle))
        win.requests += 1
        i += 1
    win.frames = win.requests
    win.seconds = time.perf_counter() - t0
    return win


def batch_loop(pipe, pool, schedule, K, clock, *, queued_ahead, seconds=None, count=None,
               start=0, sampler=None, on_request=None) -> Window:
    """Stacks through the batched pipeline, up to `queued_ahead` stacks
    queued behind the one the device runs. The window ends at the
    synchronise after the last stack dispatched within it."""
    win = Window()
    pending = deque()
    t0 = time.perf_counter()
    t_end = t0 + (seconds if seconds is not None else float("inf"))
    i = start
    while (count is None or win.requests < count) and time.perf_counter() < t_end:
        s = i % len(pool)
        length, angle = schedule(i)
        with (on_request or contextlib.nullcontext)():
            d0 = time.perf_counter()
            out, _ = pipe.run(pool[s], length, angle, K)
            win.dispatch_s.append(time.perf_counter() - d0)
        pending.append(clock.fence())
        while len(pending) > queued_ahead + 1:
            ev = pending.popleft()
            if ev is not None:
                ev.synchronize()
        if sampler is not None:
            sampler.offer(i, (s, length, angle), out)
        win.psfs.append((length, angle))
        win.requests += 1
        win.frames += pool.shape[1]
        i += 1
    clock.sync()
    win.seconds = time.perf_counter() - t0
    return win
