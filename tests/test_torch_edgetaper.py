"""The port's edge taper against the JAX package and the serial oracle.

- host/taper.py and host/edgetaper.py against their JAX twins
  (utils/taper.py, oracle/edgetaper.py): bitwise.
- models/edgetaper.py against JAX edge_taper_planes(fft_backend="pallas",
  fft_engine="roll") in interpret mode: max error <= 1e-5 of the planes'
  max magnitude.
- WienerDeblurPipeline(edgetaper=True) on the CPU against JAX
  WienerDeblurPipeline(fft_backend="pallas", edgetaper=True): restored
  planes <= 1e-5, uint8 <= 1 count; and against host/oracle.py with the
  taper at the inf tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.edgetaper import edge_taper_planes as jax_edge_taper
from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.oracle.edgetaper import edge_taper_channels as jax_oracle_taper
from fft_restoration_tpu.oracle.psf import make_psf_oracle, motion_blur_kernel_oracle
from fft_restoration_tpu.oracle.serial import restore_channels as jax_restore_channels
from fft_restoration_tpu.utils import taper as jtaper
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu_torch.host import edgetaper as host_edgetaper
from fft_restoration_tpu_torch.host import oracle, taper
from fft_restoration_tpu_torch.host.verify import channels_equal
from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes
from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

L, ANGLE, K = 15, 30.0, 0.01


@pytest.mark.parametrize("h,w,hp,wp,side", [(200, 230, 256, 256, 15), (5, 3, 8, 4, 9),
                                             (64, 64, 64, 64, 1), (1, 2, 1, 2, 4)])
def test_taper_windows_match_jax_bitwise(h, w, hp, wp, side):
    for a, b in zip(taper.taper_windows(h, w, hp, wp, side),
                    jtaper.taper_windows(h, w, hp, wp, side)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        taper.taper_window_1d(10, 8, 3)


def test_host_edgetaper_matches_jax_oracle_bitwise(rng):
    x = np.zeros((3, 128, 64), np.float32)
    x[:, :100, :50] = rng.random((3, 100, 50))
    psf = motion_blur_kernel_oracle(11, 20.0)
    ours = host_edgetaper.edge_taper_channels(x, psf, (100, 50))
    np.testing.assert_array_equal(ours, jax_oracle_taper(x, psf, (100, 50)))


def test_edge_taper_planes_matches_jax(rng):
    psf = motion_blur_kernel_oracle(9, 45.0).astype(np.float32)
    x = np.zeros((3, 256, 128), np.float32)
    x[:, :230, :100] = rng.random((3, 230, 100))
    ref = np.asarray(jax_edge_taper(jnp.asarray(x), jnp.asarray(psf), (230, 100),
                                    fft_backend="pallas", fft_engine="roll"))
    ours = edge_taper_planes(torch.from_numpy(x), torch.from_numpy(psf), (230, 100)).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    # one plane (no pair packing) and uint8 input give the same planes
    one = edge_taper_planes(torch.from_numpy(x[:1]), torch.from_numpy(psf), (230, 100)).numpy()
    assert np.abs(one[0] - ref[0]).max() <= 1e-5 * np.abs(ref).max()


def test_oracle_edgetaper_matches_jax_oracle(rng):
    img = blur_image(rng.integers(0, 256, (90, 140, 3), dtype=np.uint8), L, ANGLE)
    imgf = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    ours = oracle.restore_frame_channels(img, L, ANGLE, K, edgetaper=True)
    ref = jax_restore_channels(imgf, make_psf_oracle("motion", L, ANGLE), K, edgetaper=True)
    np.testing.assert_array_equal(ours, ref)


def test_pipeline_edgetaper_matches_jax_and_oracle(rng):
    img = blur_image(rng.integers(0, 256, (200, 230, 3), dtype=np.uint8), L, ANGLE)
    out_j, planes_j = JaxPipeline(fft_backend="pallas", edgetaper=True).restore_with_planes(
        img, L, ANGLE, K)
    out_t, planes_t = WienerDeblurPipeline("cpu", edgetaper=True).restore_with_planes(
        img, L, ANGLE, K)
    assert np.abs(planes_t - planes_j).max() <= 1e-5
    assert np.abs(out_t.astype(np.int32) - out_j.astype(np.int32)).max() <= 1
    rep = channels_equal(planes_t, oracle.restore_frame_channels(img, L, ANGLE, K, edgetaper=True),
                         "inf")
    assert rep.passed, rep
    # the taper changes the answer: the untapered oracle is not it
    plain = oracle.restore_frame_channels(img, L, ANGLE, K)
    assert np.abs(planes_t - plain).max() > 1e-3
