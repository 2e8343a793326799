"""The port's (batch, rows) mesh path against the JAX package's on the CPU:
twins of tests/test_sharded_batch.py, plus profile_phases_sharded.

JAX runs 'matmul' on the conftest's 8-device virtual CPU mesh; the port
its kernel route ('pallas', the plain versions on a device='cpu' mesh)
and 'matmul'. Held: the whole-pipeline batch (white balance, taper) to
JAX's within 1 uint8 count, RL within 2 (JAX's bound against its jit
batch), raw planes at 1e-5 relative, the batch to the port's
single-card BatchedWienerPipeline within 1 count, the phases' planes to
JAX's at 1e-5, and the tiled x mesh frame to the host stitch within 1.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu import parallel as jpar
from fft_restoration_tpu.parallel import sharded_pipeline as jsp
from fft_restoration_tpu_torch.host.oracle import make_psf_oracle
from fft_restoration_tpu_torch.models.batched import BatchedWienerPipeline
from fft_restoration_tpu_torch.models.pipeline import pad_extents, restore_planes
from fft_restoration_tpu_torch.parallel import make_mesh, make_mesh2d
from fft_restoration_tpu_torch.parallel.sharded_pipeline import (
    profile_phases_sharded,
    sharded_batched_restore_images,
    sharded_batched_restore_planes,
)

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores


def _stack(seed, b=3, h=40, w=56):
    """tests/test_sharded_batch.py's frames, from their own generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.zeros((h, w, 3), np.float32)
    base[..., 0] = 90 + 80 * np.sin(yy / 5.0)
    base[..., 1] = 60 + 2.0 * xx
    base[..., 2] = 70 + 1.5 * yy
    frames = [np.clip(base + rng.normal(0, 6, base.shape) + 10 * i, 0, 255) for i in range(b)]
    return np.stack(frames).astype(np.uint8)


def _u8_max(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("backend", ["pallas", "matmul"])
@pytest.mark.parametrize("options,tol", [({}, 1), ({"edgetaper": True}, 1),
                                         ({"filter_name": "rl", "rl_iters": 8,
                                           "white_balance": False}, 2)])
def test_batched_images_match_jax(backend, options, tol):
    stack = _stack(11, b=2 if "rl_iters" in options else 3)
    kind = "disk" if "rl_iters" in options else "motion"
    psf = make_psf_oracle(kind, 5, 30.0)
    ref = jsp.sharded_batched_restore_images(stack, psf, 0.01, mesh=jpar.make_mesh2d(2, 4),
                                             fft_backend="matmul", **options)
    ours = sharded_batched_restore_images(stack, psf, 0.01, mesh=make_mesh2d(2, 4, device="cpu"),
                                          fft_backend=backend, **options)
    assert ours.shape == stack.shape and ours.dtype == np.uint8
    assert _u8_max(ours, ref) <= tol


@pytest.mark.parametrize("pad_mode", ["pow2", "smooth"])
def test_batched_images_match_the_single_card_batch(pad_mode):
    stack = _stack(12, h=40, w=150)
    psf = make_psf_oracle("motion", 5, 30.0)
    hp, wp, rad_h, rad_w = pad_extents(40, 150, pad_mode)
    ours = sharded_batched_restore_images(stack, psf, 0.01, mesh=make_mesh2d(2, 2, device="cpu"),
                                          pad_hw=(hp, wp), radices_hw=(rad_h, rad_w))
    ref = BatchedWienerPipeline("cpu", pad_mode=pad_mode).restore(stack, 5, 30.0, 0.01)
    assert _u8_max(ours, ref) <= 1


@pytest.mark.parametrize("backend", ["pallas", "matmul"])
def test_raw_planes_match_jax_and_single_card(backend):
    """normalize=False gives the raw unscaled-inverse planes: the tiled x
    mesh contract (raw tiles of one extent stitch directly)."""
    rng = np.random.default_rng(13)
    chans = rng.random((2, 3, 32, 32)).astype(np.float32)
    psf = make_psf_oracle("motion", 5, 30.0)
    ref = jsp.sharded_batched_restore_planes(chans, psf, 0.01, mesh=jpar.make_mesh2d(2, 4),
                                             fft_backend="matmul", normalize=False)
    single = np.stack([restore_planes(torch.from_numpy(c), torch.from_numpy(psf), 0.01,
                                      normalize=False).numpy() for c in chans])
    ours = sharded_batched_restore_planes(chans, psf, 0.01, mesh=make_mesh2d(2, 4, device="cpu"),
                                          fft_backend=backend, normalize=False)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(ours - ref).max() / scale < 1e-5
    assert np.abs(ours - single).max() / scale < 1e-5


def test_profile_phases_sharded_matches_jax():
    img = _stack(14, b=1, h=40, w=56)[0]
    ref, _ = jsp.profile_phases_sharded(img, 5, 30.0, 0.01, mesh=jpar.make_mesh(4))
    ours, prof = profile_phases_sharded(img, 5, 30.0, 0.01, mesh=make_mesh(4, device="cpu"))
    assert ours.shape == (3, 40, 56)
    assert np.abs(ours - ref).max() < 1e-5
    assert [k.split(": ")[1] for k in prof.accum_ms] == [
        "Pre-process", "FFT Image", "FFT PSF", "Wiener Filter", "IFFT", "Post-process"]
    with pytest.raises(ValueError, match="divides the pow2 extents"):
        profile_phases_sharded(img, 5, 30.0, 0.01, mesh=make_mesh(3, device="cpu"))


def test_cli_batch_sharded_rl_and_taper(tmp_path, capsys):
    """A directory on --mode sharded --devices 4 (a (2, 2) mesh) takes
    --filter rl and --edgetaper and matches --mode jit."""
    from fft_restoration_tpu_torch import cli
    from fft_restoration_tpu_torch.host.imageio import imread, imwrite

    rng = np.random.default_rng(16)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(2):
        imwrite(str(d / f"f{i}.png"), (rng.random((24, 24, 3)) * 255).astype(np.uint8))
    for extra in (["--edgetaper"], ["--filter", "rl", "--iters", "4"]):
        outs, texts = {}, {}
        for mode in ("sharded", "jit"):
            out = tmp_path / f"{mode}{extra[0][2:4]}"
            rc = cli.main([str(d), "3", "30", "-o", str(out), "--device", "cpu", "--mode", mode,
                           "--devices", "4", *extra])
            texts[mode] = capsys.readouterr().out
            assert rc == 0 and "Restored 2 frames" in texts[mode], texts[mode]
            outs[mode] = out
        assert "size groups on the mesh: batch=2, rows=2 over 1 cpu device" in texts["sharded"]
        for i in range(2):
            a = imread(str(outs["sharded"] / f"f{i}_restored.png"))
            b = imread(str(outs["jit"] / f"f{i}_restored.png"))
            assert _u8_max(a, b) <= 2, extra
