"""The port's phase profiler (utils/timing.py) against the JAX package's
(fft_restoration_tpu/utils/timing.py): the same report text for the same
accumulations, with time.perf_counter replaced in both modules by one
scripted clock; and `block_on` with CPU tensors, which need no
synchronize."""

from types import SimpleNamespace

import pytest
import torch

from fft_restoration_tpu.utils import timing as jtiming
from fft_restoration_tpu_torch.utils import timing


class _Clock:
    """perf_counter stand-in: each call advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.0
        return self.t


def _patch_clocks(monkeypatch, steps):
    """Each module's `time` replaced by its own scripted perf_counter (the
    two modules share the one `time` module, so patching its attribute
    would give both one clock)."""
    for module in (jtiming, timing):
        monkeypatch.setattr(module, "time", SimpleNamespace(perf_counter=_Clock(steps)))


STEPS = [0.0, 0.0015, 0.0, 0.25, 0.0, 0.0031, 0.0, 0.0007, 0.0, 0.125, 0.0, 0.002]


@pytest.mark.parametrize("mode", ["tpu", "torch-cuda"])
def test_report_matches_jax(monkeypatch, mode):
    _patch_clocks(monkeypatch, STEPS + STEPS)
    profs = (jtiming.PhaseProfiler(mode), timing.PhaseProfiler(mode))
    for _ in range(2):  # two rounds accumulate
        for prof in profs:
            for name in timing.PHASES:
                with prof.phase(name):
                    pass
    assert timing.PHASES == jtiming.PHASES
    assert profs[1].report() == profs[0].report()
    assert list(profs[1].accum_ms) == list(profs[0].accum_ms)
    assert profs[1].report().splitlines()[0] == "=== Accumulated Time ==="
    for prof in profs:
        prof.clear()
    assert profs[1].report() == profs[0].report()


def test_block_on_cpu_tensors():
    prof = timing.PhaseProfiler("torch-cpu")
    x = torch.ones(4, 4)
    with prof.phase("FFT Image", block_on=(x, [x * 2], {"k": x})):
        y = x + 1
    with prof.phase("IFFT", block_on=y):
        pass
    assert list(prof.accum_ms) == ["torch-cpu: FFT Image", "torch-cpu: IFFT"]
    assert all(ms >= 0.0 for ms in prof.accum_ms.values())
    assert timing._cuda_devices((x, [y], {"k": x}, None, 3), set()) == set()
