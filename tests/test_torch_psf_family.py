"""The PSF family on the port's single pipeline, and the kernel-route
restore_planes, against the JAX package on the CPU.

The port runs with device='cpu' (its kernel wrappers take their plain
versions), JAX with fft_backend='matmul'; restored planes are diffed
across the two engines, spectra are not (their orders differ).
Tolerances: restore_planes' raw planes within 1e-4 of each plane's max
|x| and its normalized planes within 1e-4 (the inverse filter 2e-4, the
repo's contract for its ill-conditioned division); restored frames
within 1 uint8 count and 1e-4 planes of JAX; the oracle at the inf tier.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.models.pipeline import restore_planes as jax_restore_planes
from fft_restoration_tpu.ops.psf import make_psf as jax_make_psf
from fft_restoration_tpu_torch import WienerDeblurPipeline, deblur_image
from fft_restoration_tpu_torch.host.blurgen import blur_image
from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
from fft_restoration_tpu_torch.host.verify import channels_equal
from fft_restoration_tpu_torch.models.pipeline import psf_key, restore_planes
from fft_restoration_tpu_torch.ops.psf import make_psf

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

PLANE_REL = {"wiener": 1e-4, "cls": 1e-4, "rl": 1e-4, "inverse": 2e-4}


def _frame(seed, h, w, length, param, psf_type):
    g = np.random.default_rng(seed)
    scene = np.kron(g.integers(30, 256, (h // 8 + 1, w // 8 + 1, 3)), np.ones((8, 8, 1)))
    return blur_image(scene[:h, :w].astype(np.uint8), length, param, psf_type)


def _kernel(seed, size):
    k = np.random.default_rng(seed).random((size, size)).astype(np.float32)
    return k / k.sum()


@pytest.mark.parametrize("psf_type,size,param", [("motion", 9, 30.0), ("gaussian", 7, 1.5),
                                                 ("disk", 8, 0.0)])
def test_make_psf_matches_jax(psf_type, size, param):
    ours = make_psf(psf_type, size, param, "cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_make_psf(psf_type, size, param)),
                               rtol=0, atol=1e-7)


def test_make_psf_passes_a_kernel_through():
    k = _kernel(1, 5)
    np.testing.assert_array_equal(make_psf(k, 5, 0.0, "cpu").numpy(), k)
    np.testing.assert_array_equal(make_psf(torch.from_numpy(k), 5, 3.0, "cpu").numpy(), k)
    for fn in (lambda: make_psf(k, 6, 0.0, "cpu"), lambda: jax_make_psf(k, 6, 0.0)):
        with pytest.raises(ValueError, match=r"custom PSF kernel shape \(5, 5\) != \(6, 6\)"):
            fn()


@pytest.mark.parametrize("psf_type,length,param", [
    ("gaussian", 9, 1.8), ("disk", 7, 0.0), ("kernel", 7, 0.0),
])
def test_pipeline_psf_type_matches_jax_and_the_oracle(psf_type, length, param):
    img = _frame(length, 72, 100, length, param, "disk" if psf_type == "kernel" else psf_type)
    kind = _kernel(3, length) if psf_type == "kernel" else psf_type
    out, planes = WienerDeblurPipeline("cpu", psf_type=kind).restore_with_planes(
        img, length, param)
    j_out, j_planes = JaxPipeline(fft_backend="matmul", psf_type=kind).restore_with_planes(
        img, length, param)
    assert np.abs(planes - np.asarray(j_planes)).max() <= 1e-4
    assert np.abs(out.astype(int) - np.asarray(j_out).astype(int)).max() <= 1
    oracle = restore_frame_channels(img, length, param, 0.01, False, None, kind)
    assert channels_equal(planes, oracle, "inf").passed
    np.testing.assert_array_equal(deblur_image(img, length, param, device="cpu", psf_type=kind),
                                  out)


def test_pipeline_refuses_unknown_families_and_wrong_kernel_sizes():
    with pytest.raises(ValueError, match="unknown psf type"):
        WienerDeblurPipeline("cpu", psf_type="box")
    pipe = WienerDeblurPipeline("cpu", psf_type=_kernel(0, 5))
    with pytest.raises(ValueError, match="custom PSF kernel shape"):
        pipe.restore(np.zeros((32, 32, 3), np.uint8), 7, 0.0)


def test_array_psfs_key_the_spectrum_cache_by_their_bytes():
    """Two kernels of one size get two spectra: the cache keys on the
    kernel's bytes and shape, not on (pad, length, angle) alone."""
    img = _frame(5, 64, 64, 5, 0.0, "disk")
    k1, k2 = _kernel(1, 5), _kernel(2, 5)
    assert psf_key(k1) != psf_key(k2) and psf_key(k1) == psf_key(k1.copy())
    assert psf_key("disk") == "disk"
    pipe = WienerDeblurPipeline("cpu", psf_type=k1)
    first = pipe.restore(img, 5, 0.0)
    pipe.psf_type = k2
    second = pipe.restore(img, 5, 0.0)
    assert len(pipe._psf_cache) == 2
    np.testing.assert_array_equal(second, WienerDeblurPipeline("cpu", psf_type=k2).restore(
        img, 5, 0.0))
    assert not np.array_equal(first, second)


def _planes(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 256, 256), (2, 3, 128, 128), (128, 128)])
@pytest.mark.parametrize("filter_name,normalize", [
    ("wiener", False), ("wiener", True), ("cls", False), ("inverse", False), ("rl", False),
])
def test_restore_planes_matches_jax(shape, filter_name, normalize):
    x = _planes(sum(shape), shape)
    psf = jax_make_psf("motion", 9, 30.0)
    ref = np.asarray(jax_restore_planes(x, psf, 0.01, fft_backend="matmul",
                                        filter_name=filter_name, normalize=normalize,
                                        rl_iters=3))
    ours = restore_planes(torch.from_numpy(x), make_psf("motion", 9, 30.0, "cpu"), 0.01,
                          filter_name=filter_name, normalize=normalize, rl_iters=3).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(ours - ref) / scale).max() <= PLANE_REL[filter_name]


@pytest.mark.parametrize("normalize", [False, True])
def test_restore_planes_generic_route_matches_jax(normalize):
    x = _planes(7, (2, 3, 64, 64))
    psf = jax_make_psf("gaussian", 7, 1.5)
    ref = np.asarray(jax_restore_planes(x, psf, 0.01, fft_backend="matmul", normalize=normalize))
    ours = restore_planes(torch.from_numpy(x), make_psf("gaussian", 7, 1.5, "cpu"), 0.01,
                          fft_backend="matmul", normalize=normalize).numpy()
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(ours - ref) / scale).max() <= 1e-4


def test_restore_planes_takes_uint8_and_a_cached_spectrum():
    """uint8 planes convert x / 255; a spectrum from psf_spectrum_planes
    restores what the PSF does; raw planes normalize to the normalized
    output."""
    from fft_restoration_tpu_torch.models.pipeline import minmax_normalize, psf_spectrum_planes

    u8 = np.random.default_rng(9).integers(0, 256, (3, 128, 128), dtype=np.uint8)
    psf = make_psf("motion", 9, 30.0, "cpu")
    H = psf_spectrum_planes(psf, 128, 128)
    a = restore_planes(torch.from_numpy(u8), psf, 0.01, normalize=False)
    b = restore_planes(torch.from_numpy(u8.astype(np.float32) / np.float32(255.0)), psf, 0.01,
                       psf_spectrum=H, normalize=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    normed = restore_planes(torch.from_numpy(u8), psf, 0.01)
    assert (minmax_normalize(a) - normed).abs().max() <= 1e-6
