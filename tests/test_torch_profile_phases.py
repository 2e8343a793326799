"""The port's profile_phases (models/pipeline.py) against the JAX
package's on the CPU: the same uint8 image within 1 count (the generic
route's contract, tests/test_torch_generic_route.py) for 'matmul' and
'radix2', the six phases of the reference's taxonomy in order, a
caller's profiler accumulating, and the restore equal to the generic
pipeline's within 1 count."""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.pipeline import profile_phases as jax_profile_phases
from fft_restoration_tpu_torch import WienerDeblurPipeline
from fft_restoration_tpu_torch.models.pipeline import profile_phases
from fft_restoration_tpu_torch.utils.timing import PHASES, PhaseProfiler

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores


def _frame(seed, h, w):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def _u8_max(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("white_balance", [True, False])
@pytest.mark.parametrize("backend", ["matmul", "radix2"])
def test_profile_phases_matches_jax(backend, white_balance):
    img = _frame(21, 40, 56)
    out_j, _ = jax_profile_phases(img, 9, 30.0, 0.01, fft_backend=backend,
                                  white_balance=white_balance)
    out_t, prof = profile_phases(img, 9, 30.0, 0.01, fft_backend=backend,
                                 white_balance=white_balance, device="cpu")
    assert out_t.shape == img.shape and out_t.dtype == np.uint8
    assert _u8_max(out_t, np.asarray(out_j)) <= 1
    assert list(prof.accum_ms) == [f"torch-cpu: {p}" for p in PHASES]
    assert all(ms >= 0.0 for ms in prof.accum_ms.values())


def test_profile_phases_accumulates_and_matches_the_pipeline():
    img = _frame(22, 48, 40)
    prof = PhaseProfiler("run")
    for _ in range(2):
        out, same = profile_phases(img, 7, 60.0, 0.02, profiler=prof, device="cpu")
    assert same is prof and list(prof.accum_ms) == [f"run: {p}" for p in PHASES]
    assert "this round total:" in prof.report()
    ref = WienerDeblurPipeline("cpu", fft_backend="matmul").restore(img, 7, 60.0, 0.02)
    assert _u8_max(out, ref) <= 1
    with pytest.raises(ValueError, match="unknown fft backend"):
        profile_phases(img, 7, 60.0, device="cpu", fft_backend="cufft")
