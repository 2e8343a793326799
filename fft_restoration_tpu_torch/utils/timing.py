"""Phase profiler with the reference's phase taxonomy.

Counterpart of fft_restoration_tpu/utils/timing.py, with the same
report text. It recreates two of the reference's timing mechanisms as one
component:
  * the RAII CpuTimer + accumulator map of the serial program, printed
    as an accumulated-time table;
  * the 6-phase cudaEvent Profiler of its GPU program.

Phase taxonomy: Pre-process / FFT Image / FFT PSF / Wiener Filter /
IFFT / Post-process.

CUDA work is queued asynchronously, so a phase timer means something
only if the phase's result is on the device when the timer stops:
`phase(..., block_on=tensors)` synchronizes the device of every CUDA
tensor in `block_on` on exit (CPU tensors need nothing). For the
pipelines' own runs, whose phases overlap in the queue, read the device
timeline (trace_profile.py).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Iterator, Optional

import torch

PHASES = (
    "Pre-process",
    "FFT Image",
    "FFT PSF",
    "Wiener Filter",
    "IFFT",
    "Post-process",
)


def _cuda_devices(tree: Any, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def _block(tree: Any) -> None:
    """Wait for the devices of the CUDA tensors in `tree` (a tensor, or
    nested lists, tuples and dicts of them); CPU tensors are ready."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


class PhaseProfiler:
    """Accumulates per-phase milliseconds across calls (like g_timeAccum)."""

    def __init__(self, mode: str = "cuda"):
        self.mode = mode
        self.accum_ms: "OrderedDict[str, float]" = OrderedDict()

    def clear(self) -> None:
        self.accum_ms.clear()

    @contextmanager
    def phase(self, name: str, block_on: Optional[Any] = None) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block(block_on)
            ms = (time.perf_counter() - start) * 1e3
            key = f"{self.mode}: {name}"
            self.accum_ms[key] = self.accum_ms.get(key, 0.0) + ms

    def report(self) -> str:
        # the reference's accumulated-time table
        lines = ["=== Accumulated Time ==="]
        total = 0.0
        for name, ms in sorted(self.accum_ms.items()):
            lines.append(f"{name} total: {ms:.3f} ms")
            total += ms
        lines.append(f"this round total: {total:.3f} ms")
        lines.append("=========================")
        return "\n".join(lines)

