"""On the card, at each cell's own size: the control (the port's bf16
staging, the precision below the configuration's float32) comes out not
correct on three seeds, and the program as configured comes out correct.
Run with `python -m pytest benchmark/tests/test_control_card.py` on a
machine with a CUDA device; skipped elsewhere."""

from __future__ import annotations

import pytest

from benchmark import harness, spec
from benchmark.control import CONTROL

CELLS = ("photo_2048x2048_wiener.batch8", "uhd_3840x2160_wiener.stream",
         "uhd_3840x2160_wiener.stream_psf_per_frame", "uhd_3840x2160_wiener.batch4")
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cuda, name):
    cell = spec.load_cell(name)
    for seed in SEEDS:
        _, checked = harness.run_cell(cell, seed, 1.0, False, over=CONTROL)
        assert checked["correct"] is False, (seed, checked)
        _, checked = harness.run_cell(cell, seed, 1.0, False)
        assert checked["correct"] is True, (seed, checked)
