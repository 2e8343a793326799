"""The float64 reference against the port's CPU route at small frames:
the same PSF, the same restored planes, the same uint8 frames but for
values on a truncation edge."""

from __future__ import annotations

import pytest
import torch

from benchmark.frames import make_pool
from benchmark.reference import restore as ref

from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline
from fft_restoration_tpu_torch.ops.psf import make_psf

OPTS = dict(filter_name="wiener", pad_mode="pow2", white_balance=True, wb_stats_stride=1,
            fft_backend="pallas", fft_engine="roll", stage_dtype="f32")


@pytest.mark.parametrize("length,angle", [(9, 30.0), (20, 0.0), (33, 97.5), (60, 179.9)])
def test_motion_psf_matches_the_port(length, angle):
    got = make_psf("motion", length, angle, "cpu").double()
    want = ref.motion_psf(length, angle, "cpu")
    assert torch.allclose(got, want, rtol=0, atol=1e-7)
    assert want.sum().item() == pytest.approx(got.sum().item(), abs=1e-6)


@pytest.mark.parametrize("h,w,length,angle", [(48, 64, 9, 30.0), (80, 96, 15, 120.0),
                                              (33, 70, 5, 45.0)])
def test_reference_matches_the_port(h, w, length, angle):
    frames = make_pool(11 + h, 2, h, w, (length, angle), "cpu")
    pipe = WienerDeblurPipeline("cpu", emit_planes=True, **OPTS)
    hp, wp = ref.next_pow2(h), ref.next_pow2(w)
    H = ref.psf_spectrum(length, angle, hp, wp, "cpu")
    for frame in frames:
        out, planes = pipe.run(frame, length, angle, 0.01)
        want_planes = ref.restore_planes(frame, H, 0.01)
        assert torch.allclose(planes.double(), want_planes, rtol=0, atol=2e-5)
        want = ref.encode(want_planes, frame)
        diff = (out.to(torch.int16) - want.to(torch.int16)).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).double().mean().item() < 2e-3


def test_reference_matches_the_batched_port():
    stack = make_pool(5, 3, 40, 56, (7, 60.0), "cpu")
    out, _ = BatchedWienerPipeline("cpu", emit_planes=False, **OPTS).run(stack, 7, 60.0, 0.01)
    for frame, got in zip(stack, out):
        want = ref.restore_frame(frame, 7, 60.0, 0.01)
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        assert diff.max().item() <= 1 and (diff > 0).double().mean().item() < 2e-3


def test_reference_is_float64_and_white_balanced():
    frame = make_pool(3, 1, 32, 32, (5, 10.0), "cpu")[0]
    H = ref.psf_spectrum(5, 10.0, 32, 32, "cpu")
    planes = ref.restore_planes(frame, H, 0.01)
    assert planes.dtype == torch.float64
    assert planes.amin().item() >= 0.0 and planes.amax().item() == pytest.approx(1.0)
    out = ref.encode(planes, frame)
    orig = frame.permute(2, 0, 1).double() / 255.0
    got = out.permute(2, 0, 1).double() / 255.0
    # the white balance brings the restore's mean L to the input's
    assert ref.lab_l(*got).mean().item() == pytest.approx(ref.lab_l(*orig).mean().item(),
                                                          rel=0.05)
