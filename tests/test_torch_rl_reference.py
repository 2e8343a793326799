"""The port's Richardson-Lucy restore against the benchmark's float64 RL
reference, `benchmark/reference/rl.py`, loaded by its path as the
benchmark loads it (`benchmark.spec.reference`).

On seeded blurred uint8 frames (the benchmark's frame maker at 256^2, no
pad), `WienerDeblurPipeline(filter_name="rl")` on the CPU (the kernels'
plain versions) against `rl.restore`, both through the Lab white balance
to uint8: within `OFF_SHARE_TOL` at the reference's 10 iterations, and
above it with one iteration left out. The reference's planes before the
encode against the float64 np.fft loop of test_torch_richardson_lucy.py,
padded frames too: two float64 references agree. And the reference keeps
the interface of a reference (benchmark/reference/__init__.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, spec  # noqa: E402
from benchmark.frames import make_pool  # noqa: E402
from benchmark.reference import restore as wiener_ref  # noqa: E402
from fft_restoration_tpu_torch import WienerDeblurPipeline  # noqa: E402
from test_torch_richardson_lucy import _rl_ref  # noqa: E402

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

RL = spec.reference("rl")
CONFIG = {"pipeline": {"rl_iters": 10}}
SEED = 2**31 + 2929
# float32 against float64 through 20 divisions by the blurred plane: the
# planes drift apart by ~1e-5, which moves a truncated uint8 value by one
# count only where it sits that close to a count's edge. Nine readings
# (three seeds, PSFs (9, 45), (25, 30), (50, 30)) read 2.0e-5 to 5.6e-5 of
# the values, max_off 1; one iteration left out reads 0.44 to 0.64.
OFF_SHARE_TOL = 1e-3
# two float64 RLs: 1e-10 on a frame with no pad; on a zero-padded one the
# rim's blurred values fall to ~1e-17 against eps 1e-6, where torch.fft's
# and np.fft's float64 roundings differ, and 20 divisions there leave the
# two 3.2e-10 apart (230x200 in 256^2, PSF (25, 30))
F64_TOL = {False: 1e-10, True: 1e-9}


def _frame(h, w, psf, seed=SEED):
    return make_pool(seed, 1, h, w, psf, "cpu")[0]


@pytest.mark.parametrize("psf", [(9, 45.0), (25, 30.0)])
@pytest.mark.parametrize("iters,within", [(10, True), (9, False)])
def test_port_rl_against_the_float64_reference(psf, iters, within):
    frame = _frame(256, 256, psf)
    want = RL.restore(frame, RL.prepare(*psf, 256, 256, CONFIG, "cpu"), CONFIG)
    pipe = WienerDeblurPipeline("cpu", filter_name="rl", rl_iters=iters, emit_planes=False)
    got, _ = pipe.run(frame, *psf)
    nums = compare.frame_numbers(got, want)
    if within:
        assert nums["worst_off_share"] <= OFF_SHARE_TOL and nums["max_off"] <= 1, nums
    else:
        assert nums["worst_off_share"] > 100 * OFF_SHARE_TOL, nums


@pytest.mark.parametrize("h,w", [(256, 256), (230, 200)])
def test_reference_planes_match_the_np_fft_loop(h, w):
    psf = (25, 30.0)
    frame = _frame(h, w, psf)
    prepared = RL.prepare(*psf, h, w, CONFIG, "cpu")
    ours = RL.rl_planes(frame, prepared[1], 10).numpy()
    y = np.zeros((3,) + tuple(prepared[1].shape))
    y[:, :h, :w] = np.moveaxis(frame.numpy().astype(np.float64) / 255.0, -1, 0)
    want = _rl_ref(y, prepared[0].numpy(), 10)[:, :h, :w]
    assert ours.shape == (3, h, w)
    assert np.abs(ours - want).max() <= F64_TOL[(h, w) != tuple(prepared[1].shape)]


@pytest.mark.parametrize("h,w", [(256, 256), (230, 200)])
def test_reference_keeps_the_interface(h, w):
    assert callable(RL.prepare) and callable(RL.restore)
    psf, H = RL.prepare(25, 30.0, h, w, CONFIG, "cpu")
    assert torch.equal(psf, wiener_ref.motion_psf(25, 30.0, "cpu"))
    assert H.dtype == torch.complex128 and tuple(H.shape) == (256, 256)
    assert torch.allclose(H, wiener_ref.psf_spectrum(25, 30.0, 256, 256, "cpu"))
    frame = _frame(h, w, (25, 30.0))
    out = RL.restore(frame, (psf, H), CONFIG)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (h, w, 3)
