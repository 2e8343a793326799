"""Tiled restoration (models/tiled.py) against the JAX package's on the
CPU, and against the port's own global restore.

The port runs its kernel route with device='cpu' (the plain versions),
JAX 'matmul'. Held: the tiled frame within 1 uint8 count of JAX's in
both stitch modes (device and host), device stitch within 1 count of
host stitch on the JAX test's frame (its bound, tests/test_tiled.py) and
within JAX's own gap between them elsewhere, and the tiled
frame within > 26 dB of the port's global edge-tapered restore after a
per-channel affine alignment (the JAX test's: the two stretch over
different extents); tiled x mesh (the tiles on a (2, 2) device='cpu'
mesh) within 1 count of the host stitch, Wiener and RL tiles. Frames:
280x360 at tile 128, overlap 32.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.models import tiled as jax_tiled
from fft_restoration_tpu.utils.verify import psnr
from fft_restoration_tpu_torch.host.blurgen import blur_image
from fft_restoration_tpu_torch.models import tiled

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

H, W, S, ANGLE = 280, 360, 7, 30.0
TILE = dict(tile=128, overlap=32)


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 80 + 100 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    img[..., 1] = 60 + 0.5 * xx + 30 * np.sin(xx / 7.0)
    img[..., 2] = 70 + 0.5 * yy
    img[60:h - 60, 100:110] += 120
    img[120:130, 40:w - 40] += 90
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def blurred():
    return blur_image(_scene(21, H, W), S, ANGLE)


def _u8_max(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _affine_align(a, b):
    out = np.empty_like(b)
    for c in range(3):
        x, y = b[..., c].ravel(), a[..., c].ravel()
        A = np.vstack([x, np.ones_like(x)]).T
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        out[..., c] = b[..., c] * coef[0] + coef[1]
    return out


@pytest.mark.parametrize("extent,tile,ov", [(200, 128, 28), (1030, 1024, 32), (96, 128, 16),
                                            (500, 256, 40), (4096, 1024, 100)])
def test_grids_match_jax(extent, tile, ov):
    core = tile - 2 * ov
    assert tiled.tile_grid(extent, tile, core, ov) == jax_tiled.tile_grid(extent, tile, core, ov)
    assert tiled.clamped_grid(extent, tile, core, ov) == jax_tiled.clamped_grid(
        extent, tile, core, ov)
    starts, cstarts = tiled.clamped_grid(extent, tile, core, ov)
    covered = np.zeros(extent, bool)
    for c0 in cstarts:
        covered[c0:c0 + min(core, extent)] = True
    assert covered.all()


@pytest.mark.parametrize("tile,overlap,psf,match", [
    (100, None, 7, "power of two"), (64, 30, 7, "core"), (128, -1, 7, ">= 0"),
    (0, None, 7, "power of two"),
])
def test_validation_errors_match_jax(tile, overlap, psf, match):
    for fn in (tiled.validate_tile_params, jax_tiled.validate_tile_params):
        with pytest.raises(ValueError, match=match):
            fn(tile, overlap, psf)
    assert tiled.validate_tile_params(1024, None, 50) == jax_tiled.validate_tile_params(
        1024, None, 50) == (100, 824)


def test_tiled_restore_refuses_bad_inputs(blurred):
    with pytest.raises(ValueError, match="DFT extent"):
        tiled.tiled_restore_image(blurred, 300, ANGLE, tile=256, overlap=8, device="cpu")
    with pytest.raises(ValueError, match="BGR"):
        tiled.tiled_restore_image(blurred[..., 0], S, ANGLE, device="cpu")
    with pytest.raises(ValueError, match="unknown fft backend"):
        tiled.tiled_restore_image(blurred, S, ANGLE, fft_backend="fast", device="cpu", **TILE)


@pytest.mark.parametrize("device_stitch", [True, False])
def test_wiener_matches_jax(blurred, device_stitch):
    ours = tiled.tiled_restore_image(blurred, S, ANGLE, device_stitch=device_stitch,
                                     device="cpu", **TILE)
    ref = jax_tiled.tiled_restore_image(blurred, S, ANGLE, fft_backend="matmul",
                                        device_stitch=device_stitch, **TILE)
    assert ours.shape == blurred.shape and ours.dtype == np.uint8
    assert _u8_max(ours, ref) <= 1


@pytest.mark.parametrize("hw", [(200, 264), (H, W)])
def test_device_and_host_stitch_agree(hw):
    """Chunks of 5 tiles (the last one short) on both paths. The two grids
    hand the pixels of a band to different tiles (the device stitch's
    clamped trailing core), so the stitch modes differ by the tiles'
    approximation there: within 1 count on the JAX test's 200x264 frame
    (tests/test_tiled.py), and on 280x360 by no more than JAX's own two
    stitch modes differ on the same frame."""
    img = blur_image(_scene(21, *hw), S, ANGLE)
    a = tiled.tiled_restore_image(img, S, ANGLE, chunk=5, device="cpu", **TILE)
    b = tiled.tiled_restore_image(img, S, ANGLE, chunk=5, device_stitch=False, device="cpu",
                                  **TILE)
    ref = [jax_tiled.tiled_restore_image(img, S, ANGLE, fft_backend="matmul",
                                         device_stitch=mode, **TILE) for mode in (True, False)]
    assert _u8_max(a, b) <= max(1, _u8_max(*ref))
    if hw == (H, W):  # why the bound is JAX's own gap here, not 1
        assert _u8_max(*ref) > 1


def test_tiled_matches_the_global_restore(blurred):
    from fft_restoration_tpu_torch import WienerDeblurPipeline

    glob = WienerDeblurPipeline("cpu", edgetaper=True).restore(blurred, S, ANGLE)
    t = tiled.tiled_restore_image(blurred, S, ANGLE, chunk=4, device="cpu", **TILE)
    g = glob.astype(np.float64)
    d = psnr(g, _affine_align(g, t.astype(np.float64)), peak=255.0)
    assert d > 26.0, d


def test_rl_matches_jax(blurred):
    ours = tiled.tiled_restore_image(blurred, S, ANGLE, filter_name="rl", rl_iters=2,
                                     device="cpu", **TILE)
    ref = jax_tiled.tiled_restore_image(blurred, S, ANGLE, filter_name="rl", rl_iters=2,
                                        fft_backend="matmul", **TILE)
    assert _u8_max(ours, ref) <= 1


def test_array_psfs_of_one_size_get_their_own_spectra(blurred):
    """Two kernels of one size: each restores as JAX does with it, so the
    hoisted spectrum is not shared between them (it keys on the bytes)."""
    outs = []
    for seed in (1, 2):
        k = np.random.default_rng(seed).random((S, S)).astype(np.float32)
        k /= k.sum()
        ours = tiled.tiled_restore_image(blurred, S, 0.0, psf_type=k, white_balance=False,
                                         device="cpu", **TILE)
        ref = jax_tiled.tiled_restore_image(blurred, S, 0.0, psf_type=k, white_balance=False,
                                            fft_backend="matmul", **TILE)
        assert _u8_max(ours, ref) <= 1
        outs.append(ours)
    assert _u8_max(*outs) > 1


def test_single_tile_frame_and_generic_route():
    """A frame smaller than one tile takes the single-tile path; the
    generic route ('matmul') restores tiles as JAX's does."""
    img = blur_image(_scene(8, 100, 120), S, ANGLE)
    for backend in ("pallas", "matmul"):
        ours = tiled.tiled_restore_image(img, S, ANGLE, tile=256, overlap=32,
                                         fft_backend=backend, device="cpu")
        ref = jax_tiled.tiled_restore_image(img, S, ANGLE, tile=256, overlap=32,
                                            fft_backend="matmul")
        assert ours.shape == img.shape and _u8_max(ours, ref) <= 1


def test_plain_ops_give_the_kernel_routes_frame(blurred):
    """ops=PLAIN_OPS (the reference run on the card): on the CPU the
    kernel wrappers take the same plain versions, so the frames agree."""
    from fft_restoration_tpu_torch.models.pipeline import PLAIN_OPS

    a = tiled.tiled_restore_image(blurred, S, ANGLE, device="cpu", **TILE)
    b = tiled.tiled_restore_image(blurred, S, ANGLE, device="cpu", ops=PLAIN_OPS, **TILE)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("options", [{}, {"filter_name": "rl", "rl_iters": 3}])
def test_tiled_mesh_matches_host_stitch(blurred, options):
    """Tiled x mesh: each chunk's tile stack restored over a (2, 2) mesh
    (parallel.sharded_pipeline.sharded_batched_restore_planes, taper and
    raw restore per tile) gives the single-card host stitch."""
    from fft_restoration_tpu_torch.parallel import make_mesh2d

    kw = dict(device="cpu", **TILE, **options)
    host = tiled.tiled_restore_image(blurred, S, ANGLE, device_stitch=False, **kw)
    ours = tiled.tiled_restore_image(blurred, S, ANGLE, mesh=make_mesh2d(2, 2, device="cpu"), **kw)
    assert ours.shape == blurred.shape
    assert _u8_max(ours, host) <= 1
