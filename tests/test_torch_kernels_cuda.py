"""Each hand-written kernel against its plain version, on an NVIDIA GPU.

Skips where there is no card. On a machine with one (which need not have
JAX) run:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: FFT family and spectral middle 1e-5 of the output's max
magnitude (float32, FMA contraction, same tables); Lab-L partials rel
1e-4 (hardware ex2/lg2 and summation order); uint8 <= 1 count.
"""

import numpy as np
import pytest
import torch

pytestmark = [
    pytest.mark.requires_cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU"),
]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture
def dev():
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(7)


@pytest.mark.parametrize("h,w", [(330, 640), (782, 1920), (64, 2), (1, 4096)])
@pytest.mark.parametrize("transposed", [True, False])
def test_fft_rows_u8_frame(dev, gen, h, w, transposed):
    from fft_restoration_tpu_torch.host.padding import next_power_of_two
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    frame = torch.as_tensor(gen.integers(0, 256, (h, w, 3), dtype=np.uint8), device=dev)
    c = frame.permute(2, 0, 1)
    ext = (next_power_of_two(h), next_power_of_two(w))
    ours = fk.fft_rows(c[0::2], c[1::2], transposed=transposed, extent=ext)
    ref = fk.fft_rows_plain(c[0::2], c[1::2], transposed=transposed, extent=ext)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= 1e-5


@pytest.mark.parametrize("m,n", [(256, 2048), (2048, 256), (8, 4096)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_rows_complex_and_packed(dev, gen, m, n, inverse):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    re, im = (torch.as_tensor(gen.standard_normal((2, m, n), dtype=np.float32), device=dev)
              for _ in range(2))
    for o, r in zip(fk.fft_rows(re, im, inverse=inverse),
                    fk.fft_rows_plain(re, im, inverse=inverse)):
        assert _rel(o, r) <= 1e-5
    out, mm = fk.fft_rows_packed_out(re, im, inverse=inverse)
    out_p, mm_p = fk.fft_rows_packed_out_plain(re, im, inverse=inverse)
    assert _rel(out, out_p) <= 1e-5 and _rel(mm, mm_p) <= 1e-5


@pytest.mark.parametrize("m,n", [(2048, 2048), (1024, 2048), (512, 128)])
def test_wiener_spectral_t(dev, gen, m, n):
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    a_re, a_im = (torch.as_tensor(gen.standard_normal((2, m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    h_re, h_im = (torch.as_tensor(gen.standard_normal((m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    ours = ws.wiener_spectral_t(a_re, a_im, h_re, h_im, 0.01)
    ref = ws.wiener_spectral_t_plain(a_re, a_im, h_re, h_im, 0.01)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= 1e-5


@pytest.mark.parametrize("live,stride,block", [((782, 1920), 1, 64), ((782, 1920), 4, 8),
                                               ((2048, 2048), 4, 8), ((100, 130), 1, 64)])
def test_postprocess_kernels(dev, gen, live, stride, block):
    from fft_restoration_tpu_torch.host.padding import next_power_of_two
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp

    h, w = live
    raw = torch.as_tensor(
        gen.standard_normal((4, next_power_of_two(h), next_power_of_two(w)), dtype=np.float32),
        device=dev,
    )
    lo = raw[:3].amin((1, 2))
    scale = 1.0 / (raw[:3].amax((1, 2)) - lo)
    frame = torch.as_tensor(gen.integers(0, 256, (h, w, 3), dtype=np.uint8), device=dev)
    orig = frame.permute(2, 0, 1)
    parts = pp.lab_l_sum_partials(raw, orig, lo, scale, live, stride, block)
    parts_p = pp.lab_l_sum_partials_plain(raw, orig, lo, scale, live, stride, block)
    assert parts.shape == parts_p.shape and _rel(parts, parts_p) <= 1e-4
    gain = torch.tensor([1.1], device=dev)
    enc = pp.wb_encode_u8(raw, gain, lo, scale, live)
    enc_p = pp.wb_encode_u8_plain(raw, gain, lo, scale, live)
    assert enc.shape == (h, w, 3)
    assert int((enc.int() - enc_p.int()).abs().max()) <= 1


def test_pipeline_kernels_vs_plain_and_launches(dev, gen):
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, _restore_core, pad_extents, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.ops.kernels import KERNELS, launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.psf import make_psf

    img = blur_image(gen.integers(0, 256, (300, 520, 3), dtype=np.uint8), 21, 60.0)
    reset_launch_counts()
    out, planes = WienerDeblurPipeline("cuda").restore_with_planes(img, 21, 60.0, 0.01)
    assert all(launch_counts[k] > 0 for k in KERNELS), dict(launch_counts)
    H = psf_spectrum_planes(make_psf("motion", 21, 60.0, dev), *pad_extents(300, 520), PLAIN_OPS)
    out_p, planes_p = _restore_core(torch.as_tensor(img, device=dev), H, 0.01, white_balance=True,
                                    emit_planes=True, wb_stats_stride=1, ops=PLAIN_OPS)
    assert np.abs(planes - planes_p.cpu().numpy()).max() <= 1e-4
    assert np.abs(out.astype(np.int32) - out_p.cpu().numpy().astype(np.int32)).max() <= 1
