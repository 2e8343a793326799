"""Blind PSF and noise estimation (models/estimate.py) against the JAX
package's estimators on the CPU.

The port runs its default 'pallas' route with device='cpu' (B6's plain
version), JAX its default 'matmul'. Held: the same (length, angle) — the
cepstrum of a real frame is even, so the peak and its mirror tie up to
rounding and either one gives the same length and angle mod 180 (to
1e-9 degrees) — the same disk size and noise K; the gaussian sigma within 1e-4 relative; every
confidence within 1e-3 relative; the noise sigma within 1e-5 relative.
The scenes are the JAX tests' (tests/test_estimate.py), each drawn from
its own generator.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.models import estimate as jax_est
from fft_restoration_tpu_torch.host.blurgen import blur_image
from fft_restoration_tpu_torch.models import estimate as est

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

CONF_REL = 1e-3


def _scene(seed, h=256, w=320):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    img[..., 1] = 60 + 0.5 * xx + 30 * np.sin(xx / 7.0)
    img[..., 2] = 70 + 0.5 * yy
    img[60:h - 56, 100:110] += 120
    img[120:130, 40:w - 40] += 90
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def _rect_scene(h=256, w=320, seed=7):
    """Random rectangles over a gradient: a power-law spectrum (the
    gaussian estimator's prior)."""
    r = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img += (0.3 * xx / w + 0.2 * yy / h)[..., None]
    for _ in range(60):
        y0, x0 = r.integers(0, h - 8), r.integers(0, w - 8)
        hh, ww = r.integers(8, h // 3), r.integers(8, w // 3)
        img[y0:y0 + hh, x0:x0 + ww] += r.uniform(-0.4, 0.4, 3).astype(np.float32)
    img += r.normal(0, 0.02, img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _angle_diff(a, b):
    d = abs((a - b) % 180.0)
    return min(d, 180.0 - d)


def _close(a, b, rel):
    return abs(a - b) <= rel * abs(b)


def _same_blur(ours, ref):
    """Equal lengths, and angles equal mod 180 (the mirrored peak)."""
    return ours[0] == ref[0] and _angle_diff(ours[1], ref[1]) < 1e-9


HW = [(256, 256), (300, 420)]


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("true_len,true_ang", [(21, 30.0), (15, 75.0), (25, -45.0)])
def test_motion_matches_jax_and_recovers_the_blur(hw, true_len, true_ang):
    blurred = blur_image(_scene(true_len, *hw), true_len, true_ang)
    length, angle, conf = est.estimate_motion_psf(blurred, device="cpu")
    j_length, j_angle, j_conf = jax_est.estimate_motion_psf(blurred)
    assert _same_blur((length, angle), (j_length, j_angle)), (length, angle, j_length, j_angle)
    assert _close(conf, j_conf, CONF_REL), (conf, j_conf)
    # the JAX tests' bounds (tests/test_estimate.py)
    assert abs(length - true_len) <= 2 and _angle_diff(angle, true_ang) <= 3.0
    assert conf > 12.0, conf


@pytest.mark.parametrize("backend", ["matmul", "radix2"])
def test_motion_on_the_generic_backends(backend):
    blurred = blur_image(_scene(3), 21, 30.0)
    length, angle, conf = est.estimate_motion_psf(blurred, fft_backend=backend, device="cpu")
    j_length, j_angle, j_conf = jax_est.estimate_motion_psf(blurred, fft_backend=backend)
    assert _same_blur((length, angle), (j_length, j_angle)) and _close(conf, j_conf, CONF_REL)


def test_motion_on_gray_float_frames_and_max_length():
    blurred = blur_image(_scene(4), 21, 30.0).astype(np.float32).mean(-1)
    for kw in ({}, {"max_length": 15}):
        ours = est.estimate_motion_psf(blurred, device="cpu", **kw)
        ref = jax_est.estimate_motion_psf(blurred, **kw)
        assert _same_blur(ours, ref) and _close(ours[2], ref[2], CONF_REL)
    assert est.estimate_motion_psf(np.zeros((16, 16, 3), np.uint8), device="cpu")[2] == 0.0


def test_tiny_frames_are_refused():
    for fn in (est.estimate_motion_psf, est.estimate_disk_psf):
        with pytest.raises(ValueError, match="too small"):
            fn(np.zeros((10, 64, 3), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="too small"):
        est.estimate_gaussian_psf(np.zeros((31, 64, 3), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="too small"):
        est.estimate_noise_K(np.zeros((2, 2), np.uint8), device="cpu")


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("true_size", [7, 11])
def test_disk_matches_jax(hw, true_size):
    blurred = blur_image(_rect_scene(*hw), true_size, 0.0, "disk")
    size, conf = est.estimate_disk_psf(blurred, device="cpu")
    j_size, j_conf = jax_est.estimate_disk_psf(blurred)
    assert size == j_size and _close(conf, j_conf, CONF_REL), (size, j_size, conf, j_conf)
    assert abs(size - true_size) <= 1 and conf > est.DISK_CONF_WARN
    assert est.estimate_disk_psf(blurred, max_size=5, device="cpu")[0] <= 5


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("true_sigma", [1.5, 2.5])
def test_gaussian_matches_jax(hw, true_sigma):
    blurred = blur_image(_rect_scene(*hw), est.gaussian_ksize(true_sigma), true_sigma,
                         "gaussian")
    sigma, conf = est.estimate_gaussian_psf(blurred, device="cpu")
    j_sigma, j_conf = jax_est.estimate_gaussian_psf(blurred)
    assert _close(sigma, j_sigma, 1e-4) and _close(conf, j_conf, CONF_REL)
    assert abs(sigma - true_sigma) / true_sigma < 0.2 and conf > 2.0
    assert est.gaussian_ksize(sigma) == jax_est.gaussian_ksize(j_sigma)


def test_constants_are_the_jax_packages():
    assert est.CONF_WARN == jax_est._CONF_WARN
    assert est.DISK_CONF_WARN == jax_est._DISK_CONF_WARN
    assert est.GAUSS_CONF_WARN == jax_est._GAUSS_CONF_WARN
    assert est.DISK_RING_CAL == jax_est._DISK_RING_CAL
    np.testing.assert_array_equal(est.GAUSS_SIGMA_GRID, jax_est._GAUSS_SIGMA_GRID)
    for s in (0.1, 1.0, 2.4, 7.9):
        assert est.gaussian_ksize(s) == jax_est.gaussian_ksize(s)


@pytest.mark.parametrize("true_sigma", [0.005, 0.02, 0.05])
def test_noise_K_matches_jax(true_sigma):
    rng = np.random.default_rng(int(true_sigma * 1000))
    h, w = 256, 320
    base = np.linspace(0.2, 0.8, w, dtype=np.float32)[None, :].repeat(h, 0)
    noisy = np.clip(base + rng.normal(0, true_sigma, (h, w)), 0, 1)
    for frame in ((noisy[..., None].repeat(3, -1) * 255).astype(np.uint8), noisy):
        sigma, k = est.estimate_noise_K(frame, device="cpu")
        j_sigma, j_k = jax_est.estimate_noise_K(frame)
        assert k == j_k and _close(sigma, j_sigma, 1e-5), (sigma, j_sigma, k, j_k)
    assert abs(sigma - true_sigma) / true_sigma < 0.15
    _, k0 = est.estimate_noise_K((base * 255).astype(np.uint8)[..., None], device="cpu")
    assert k0 == pytest.approx(1e-4)


def test_median_and_variance_follow_jnp():
    """jnp.nanmedian interpolates an even count's two middle values
    (torch.median takes the lower one) and jnp.var is the population
    variance (torch.var's default divides by n - 1)."""
    import jax.numpy as jnp

    v = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(est._median(v)) == float(jnp.nanmedian(jnp.asarray([4.0, 1.0, 3.0, 2.0]))) == 2.5
    assert float(torch.median(v)) == 2.0
    assert float(est._median(torch.tensor([3.0, 1.0, 2.0]))) == 2.0
    gray = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    sigma, var = est._noise_stats(torch.nn.functional.pad(gray, (1, 1, 1, 1)))
    j_var = float(jnp.var(jnp.pad(jnp.asarray(gray.numpy()), 1)))
    assert var == pytest.approx(j_var, rel=1e-6)
    assert est._noise_stats(torch.arange(1.0, 5.0).reshape(2, 2).repeat(2, 2))[1] == 1.25


def test_plain_ops_run_the_same_estimate():
    """ops=PLAIN_OPS (the reference run on the card) takes fft_rows' plain
    version: on the CPU both are the plain version, the same numbers."""
    from fft_restoration_tpu_torch.models.pipeline import PLAIN_OPS

    blurred = blur_image(_scene(6), 21, 30.0)
    assert est.estimate_motion_psf(blurred, device="cpu", ops=PLAIN_OPS) == \
        est.estimate_motion_psf(blurred, device="cpu")
