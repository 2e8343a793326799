"""The port's sharded restore (fft_restoration_tpu_torch/parallel/) against
the JAX package's on the CPU: twins of tests/test_sharded.py.

The same numpy operands, made from a seed, go to the JAX functions on
the conftest's 8-device virtual CPU mesh ('matmul', 'radix2', and
'pallas' in interpret mode at <= 32x64) and to the port on a
device='cpu' mesh (the kernels' plain versions). Held: the exchange
order to jax.lax.all_to_all exactly; sharded_fft2d to np.fft.fft2 at
1e-5 relative; restored planes to JAX's at 1e-5 (matmul, radix2) and
1e-4 (pallas: JAX's MXU-engine spectra are in another order than the
port's, so the planes, not the spectra, are compared); the pipeline to
the port's oracle at the l2, inf and gpu tiers; non-pow2 meshes (3, 5,
6), CLS on 3 shards and 2D meshes to the single-card restore at 1e-5;
one shard to the single pipeline at 1e-5 / 1 count; RL to JAX's sharded
RL within 3 counts (JAX's own bound, tests/test_richardson_lucy.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fft_restoration_tpu import parallel as jpar
from fft_restoration_tpu.parallel import sharded_fft as jsfft
from fft_restoration_tpu.parallel import sharded_pipeline as jsp
from fft_restoration_tpu_torch.host.blurgen import blur_image
from fft_restoration_tpu_torch.host.oracle import motion_psf, restore_frame_channels
from fft_restoration_tpu_torch.host.verify import channels_equal
from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline, restore_planes
from fft_restoration_tpu_torch.parallel import (
    ShardedWienerPipeline,
    make_mesh,
    make_mesh2d,
    sharded_fft2d,
    sharded_restore_planes,
)
from fft_restoration_tpu_torch.parallel import sharded_fft
from fft_restoration_tpu_torch.parallel.sharded_pipeline import sharded_batched_restore_planes

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

CPU = "cpu"


def _u8_max(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _blocks(x, d):
    """A global array's row blocks as the port's shard list."""
    return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(d, dim=-2))


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_shapes_and_layout():
    m = make_mesh(8, device=CPU)
    assert m.shape == {"rows": 8} and m.size == 8 and m.n_cards == 1
    assert m.devices.size == jpar.make_mesh(8).devices.size
    m2 = make_mesh2d(2, 4, device=CPU)
    assert m2.shape == {"batch": 2, "rows": 4} == dict(jpar.make_mesh2d(2, 4).shape)
    assert [len(g) for g in m2.groups()] == [4, 4]
    assert m.describe() == "rows=8 over 1 cpu device"
    assert make_mesh(device=CPU).size == 1


def test_mesh_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: make_mesh(2), lambda: make_mesh2d(1, 2), lambda: make_mesh(),
                 lambda: ShardedWienerPipeline()):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, device=CPU)


# ---------------------------------------------------------------------------
# the exchange


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("direction", ["rows_to_cols", "cols_to_rows"])
def test_reshard_order_matches_all_to_all(d, direction):
    """Distinct values through JAX's tiled all_to_all on the virtual mesh
    and through the port's exchange: chunk j of shard i lands in shard
    j's block i, in both directions, bit for bit."""
    x = np.arange(2 * 16 * 24, dtype=np.float32).reshape(2, 16, 24)
    rows, cols = P(None, jpar.ROWS_AXIS, None), P(None, None, jpar.ROWS_AXIS)
    if direction == "rows_to_cols":
        fn, specs = jsfft._reshard_rows_to_cols, (rows, cols)
        ours = torch.cat(sharded_fft.reshard_rows_to_cols(_blocks(x, d)), dim=-1).numpy()
    else:
        fn, specs = jsfft._reshard_cols_to_rows, (cols, rows)
        blocks = list(torch.from_numpy(x).chunk(d, dim=-1))
        ours = torch.cat(sharded_fft.reshard_cols_to_rows(blocks), dim=-2).numpy()
    ref = jax.jit(jax.shard_map(lambda b: fn(b, jpar.ROWS_AXIS), mesh=jpar.make_mesh(d),
                                check_vma=False, in_specs=(specs[0],), out_specs=specs[1]))(
        jnp.asarray(x))
    np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("d", [1, 3, 4])
def test_swap_exchange_is_the_exchange_and_the_swap(d):
    x = np.arange(3 * 12 * 24, dtype=np.float32).reshape(3, 12, 24)
    blocks = _blocks(x, d)
    swapped = sharded_fft.swap_exchange(blocks)
    for got, ref in zip(swapped, sharded_fft.reshard_rows_to_cols(blocks)):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), ref.transpose(-1, -2).numpy())
    back = sharded_fft.swap_exchange(swapped)
    np.testing.assert_array_equal(torch.cat(back, dim=-2).numpy(), x)


# ---------------------------------------------------------------------------
# the sharded FFT and restore


BACKENDS = ("matmul", "radix2", "pallas")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_fft2d_matches_npfft(backend, inverse):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    devs = make_mesh(8, device=CPU).groups()[0]
    blocks = _blocks(x, 8)
    re, im = sharded_fft2d(devs, blocks, [torch.zeros_like(b) for b in blocks], inverse, backend)
    ours = torch.cat(re, -2).numpy() + 1j * torch.cat(im, -2).numpy()
    ref = np.fft.fft2(x.astype(np.complex128))
    if inverse:
        ref = np.conj(np.fft.fft2(np.conj(x.astype(np.complex128))))  # unscaled ifft
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("backend,hw,tol", [("matmul", (64, 64), 1e-5), ("radix2", (64, 64), 1e-5),
                                            ("pallas", (32, 64), 1e-4)])
def test_sharded_planes_match_jax(backend, hw, tol):
    rng = np.random.default_rng(1)
    chans = rng.random((3,) + hw).astype(np.float32)
    psf = motion_psf(9, 30.0)
    ref = jpar.sharded_restore_planes(chans, psf, 0.01, mesh=jpar.make_mesh(8),
                                      fft_backend=backend)
    ours = sharded_restore_planes(chans, psf, 0.01, mesh=make_mesh(8, device=CPU),
                                  fft_backend=backend)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < tol


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_pipeline_matches_oracle(backend):
    rng = np.random.default_rng(2)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    ours = ShardedWienerPipeline(mesh=make_mesh(8, device=CPU),
                                 fft_backend=backend).restore_channels(img, 9, 30.0)
    oracle = restore_frame_channels(img, 9, 30.0)
    for tier in ("l2", "inf", "gpu"):
        report = channels_equal(ours, oracle, tier)
        assert report.passed, str(report)


@pytest.mark.parametrize("n_dev", [3, 5, 6])
@pytest.mark.parametrize("backend", ["pallas", "matmul"])
def test_nonpow2_mesh_matches_single_card(n_dev, backend):
    """A mesh that does not divide the extents pads the LAYOUT only: the
    transforms and the normalize stay at the true pow2 size, so the
    planes match the single-card restore and JAX's sharded one."""
    rng = np.random.default_rng(3)
    chans = rng.random((3, 64, 64)).astype(np.float32)
    psf = motion_psf(9, 30.0)
    single = restore_planes(torch.from_numpy(chans), torch.from_numpy(psf), 0.01,
                            fft_backend=backend).numpy()
    ours = sharded_restore_planes(chans, psf, 0.01, mesh=make_mesh(n_dev, device=CPU),
                                  fft_backend=backend)
    assert ours.shape == single.shape
    assert np.abs(single - ours).max() < 1e-5
    if backend == "matmul":
        ref = jpar.sharded_restore_planes(chans, psf, 0.01, mesh=jpar.make_mesh(n_dev))
        assert np.abs(ref - ours).max() < 1e-5


def test_nonpow2_mesh_pipeline_matches_oracle():
    rng = np.random.default_rng(4)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    ours = ShardedWienerPipeline(mesh=make_mesh(3, device=CPU)).restore_channels(img, 9, 30.0)
    oracle = restore_frame_channels(img, 9, 30.0)
    for tier in ("l2", "inf", "gpu"):
        report = channels_equal(ours, oracle, tier)
        assert report.passed, str(report)


@pytest.mark.parametrize("backend", ["pallas", "matmul"])
def test_nonpow2_mesh_cls_filter(backend):
    """CLS on 3 shards: the periodic Laplacian wraps at the TRUE extent,
    not at the layout-pad edge."""
    rng = np.random.default_rng(5)
    chans = rng.random((1, 32, 32)).astype(np.float32)
    psf = motion_psf(7, 45.0)
    ref = jpar.sharded_restore_planes(chans, psf, 0.01, mesh=jpar.make_mesh(3),
                                      filter_name="cls")
    single = restore_planes(torch.from_numpy(chans), torch.from_numpy(psf), 0.01,
                            fft_backend=backend, filter_name="cls").numpy()
    ours = sharded_restore_planes(chans, psf, 0.01, mesh=make_mesh(3, device=CPU),
                                  fft_backend=backend, filter_name="cls")
    assert np.abs(ref - ours).max() < 1e-5
    assert np.abs(single - ours).max() < 1e-5


@pytest.mark.parametrize("n_b,n_r", [(1, 8), (2, 4), (4, 2)])
def test_batched_2d_mesh_matches_jax_and_single_card(n_b, n_r):
    rng = np.random.default_rng(6)
    imgs = rng.random((3, 2, 32, 32)).astype(np.float32)  # B = 3: the batch layout pad
    psf = motion_psf(7, 30.0)
    ref = jpar.sharded_batched_restore_planes(imgs, psf, 0.01, mesh=jpar.make_mesh2d(n_b, n_r))
    single = np.stack([restore_planes(torch.from_numpy(c), torch.from_numpy(psf), 0.01).numpy()
                       for c in imgs])
    ours = sharded_batched_restore_planes(imgs, psf, 0.01, mesh=make_mesh2d(n_b, n_r, device=CPU))
    assert ours.shape == imgs.shape
    assert np.abs(ours - ref).max() < 1e-5
    assert np.abs(ours - single).max() < 1e-5


@pytest.mark.parametrize("options", [{}, {"edgetaper": True}, {"filter_name": "rl", "rl_iters": 3},
                                     {"pad_mode": "smooth"}, {"psf_type": "gaussian"}])
def test_one_shard_mesh_matches_single_pipeline(options):
    """One shard runs the whole sharded body (degenerate exchanges) and
    gives the single-card pipeline's restore; the taper, RL, the smooth
    pad and the gaussian PSF too."""
    rng = np.random.default_rng(7)
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    angle = 1.5 if options.get("psf_type") == "gaussian" else 30.0
    out_s, planes_s = ShardedWienerPipeline(mesh=make_mesh(1, device=CPU),
                                            **options).restore_with_planes(img, 7, angle)
    out_1, planes_1 = WienerDeblurPipeline(CPU, **options).restore_with_planes(img, 7, angle)
    assert np.abs(planes_s - planes_1).max() <= 1e-5
    assert _u8_max(out_s, out_1) <= 1


@pytest.mark.parametrize("backend", ["matmul", "pallas"])
def test_taper_matches_jax(backend):
    rng = np.random.default_rng(8)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    ref_out, ref = jpar.ShardedWienerPipeline(mesh=jpar.make_mesh(4), fft_backend="matmul",
                                              edgetaper=True).restore_with_planes(img, 5, 30.0)
    out, ours = ShardedWienerPipeline(mesh=make_mesh(4, device=CPU), fft_backend=backend,
                                      edgetaper=True).restore_with_planes(img, 5, 30.0)
    assert np.abs(ours - ref).max() <= 1e-5
    assert _u8_max(out, ref_out) <= 1


def _rl_scene():
    yy, xx = np.mgrid[0:48, 0:64]
    scene = np.zeros((48, 64, 3), np.float32)
    scene[..., 0] = 80 + 90 * np.sin(yy / 9.0) * np.cos(xx / 11.0)
    scene[..., 1] = 60 + 1.5 * xx
    scene[..., 2] = 70 + 2.0 * yy
    scene[12:36, 28:34] += 110
    return blur_image(np.clip(scene, 0, 255).astype(np.uint8), 7, 45.0)


@pytest.mark.parametrize("backend", ["matmul", "pallas"])
def test_rl_matches_jax_sharded_rl(backend):
    """JAX's sharded RL test's scene and bound (3 counts: RL's divisions
    amplify float32 rounding between equivalent transforms)."""
    img = _rl_scene()
    ref = jpar.ShardedWienerPipeline(mesh=jpar.make_mesh(8), fft_backend="matmul",
                                     filter_name="rl", rl_iters=4).restore(img, 7, 45.0)
    ours = ShardedWienerPipeline(mesh=make_mesh(8, device=CPU), fft_backend=backend,
                                 filter_name="rl", rl_iters=4).restore(img, 7, 45.0)
    assert _u8_max(ours, ref) <= 3


def test_gaussian_psf_matches_jax():
    rng = np.random.default_rng(9)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    ref = jpar.ShardedWienerPipeline(mesh=jpar.make_mesh(4), psf_type="gaussian"
                                     ).restore_channels(img, 9, 1.8)
    ours = ShardedWienerPipeline(mesh=make_mesh(4, device=CPU), psf_type="gaussian"
                                 ).restore_channels(img, 9, 1.8)
    assert np.abs(ours - ref).max() <= 1e-5


def test_float_frames_are_0_to_255_values():
    """A float frame is 0..255 values, as the single pipeline reads one."""
    rng = np.random.default_rng(11)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    pipe = ShardedWienerPipeline(mesh=make_mesh(3, device=CPU))
    out, planes = pipe.restore_with_planes(img.astype(np.float64), 7, 30.0)
    out_1, planes_1 = WienerDeblurPipeline(CPU).restore_with_planes(img.astype(np.float64), 7, 30.0)
    assert np.abs(planes - planes_1).max() <= 1e-5 and _u8_max(out, out_1) <= 1


def test_refuses_bad_inputs():
    mesh = make_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="unknown filter"):
        ShardedWienerPipeline(mesh=mesh, filter_name="nope")
    with pytest.raises(ValueError, match="unknown fft backend"):
        ShardedWienerPipeline(mesh=mesh, fft_backend="nope")
    with pytest.raises(ValueError, match="PSF length"):
        ShardedWienerPipeline(mesh=mesh).restore(np.zeros((8, 8, 3), np.uint8), 9, 0.0)
    with pytest.raises(ValueError, match="does not fit"):
        sharded_restore_planes(np.zeros((1, 8, 8), np.float32), np.ones((9, 9), np.float32),
                               mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        sharded_restore_planes(np.zeros((1, 8, 8), np.float32), np.ones((3, 3), np.float32),
                               mesh=jpar.make_mesh(2))


def test_sharded_cards_tool_on_cpu(capsys):
    """tools/sharded_cards.py (the sharded path over every card against
    the single route) runs its meshes on CPU shards and holds them."""
    import json

    from fft_restoration_tpu_torch.tools import sharded_cards

    assert sharded_cards.main(["--device", CPU, "--size", "64", "--psf-length", "5"]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["cards"] == 1 and {"rows1", "rows2", "rows1_rl_taper", "batch8"} <= set(res)
    assert all(res[k]["uint8_max"] <= 1 for k in ("rows1", "rows2", "batch8"))


def test_jax_sharded_core_and_the_ports_agree_at_one_device():
    """JAX's own one-device sharded core (the real-TPU validation config)
    and the port's one-shard pipeline, on float frames made from a seed."""
    import functools

    rng = np.random.default_rng(10)
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    sh = jax.jit(functools.partial(jsp._sharded_core, mesh=jpar.make_mesh(1), psf_length=7,
                                   fft_backend="matmul", filter_name="wiener",
                                   white_balance=True))
    out_j, planes_j = sh(jnp.asarray(img.astype(np.float32) / np.float32(255.0)),
                         jnp.float32(30.0), jnp.float32(0.01))
    out, planes = ShardedWienerPipeline(mesh=make_mesh(1, device=CPU)).restore_with_planes(
        img, 7, 30.0)
    assert np.abs(planes - np.asarray(planes_j)).max() <= 1e-5
    assert _u8_max(out, np.asarray(out_j)) <= 1
