"""Richardson-Lucy, the edge taper and the batched pipeline on the
generic route (fft_backend other than 'pallas': models/convolve.py's
natural-order conv, models/pipeline.restore_stack_generic) against the
JAX package's twins on the same backend, on the CPU.

Tolerances, as tests/test_torch_richardson_lucy.py and
tests/test_torch_edgetaper.py hold the kernel route: RL 5e-2 plane INF
(its divisions amplify float32 rounding), uint8 at most 8 counts and a
mean of at most 0.2; the taper 1e-5 of the planes' max magnitude, and
its restore 1e-5 planes and 1 uint8 count; the batched Wiener restore
1e-5 planes and 1 count (tests/test_torch_batched.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.batched import BatchedWienerPipeline as JaxBatched
from fft_restoration_tpu.models.edgetaper import edge_taper_planes as jax_edge_taper
from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.models.richardson_lucy import richardson_lucy_planes as jax_rl
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu_torch import (
    BatchedWienerPipeline,
    WienerDeblurPipeline,
    edge_taper_planes,
    richardson_lucy_planes,
)
from fft_restoration_tpu_torch.models import convolve

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

RL_INF, RL_U8_MAX, RL_U8_MEAN = 5e-2, 8, 0.2
TAPER_REL = 1e-5
L, ANGLE, K = 9, 30.0, 0.01


def _u8(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float(d.mean())


def _smooth_frames(seed, n, h, w):
    """Blurred block scenes on a grey floor (as tests/test_torch_filters.py
    makes them): RL turns rounding into counts where y and the blur vanish."""
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = np.kron(g.integers(40, 256, (h // 8 + 1, w // 8 + 1, 3)), np.ones((8, 8, 1)))
        out.append(blur_image(s[:h, :w].astype(np.uint8), 7, ANGLE))
    return np.stack(out)


def _planes(seed, shape, live=None):
    """float32 planes in [0, 1), zero outside the top-left `live` extent."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    if live is not None:
        x[..., live[0]:, :] = 0.0
        x[..., :, live[1]:] = 0.0
    return x


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 3, 64, 96)])
def test_rl_matmul_matches_jax(shape):
    psf = motion_blur_kernel_oracle(L, 45.0).astype(np.float32)
    y = _planes(31, shape)
    ref = np.asarray(jax_rl(jnp.asarray(y), jnp.asarray(psf), 3, fft_backend="matmul"))
    ours = richardson_lucy_planes(torch.from_numpy(y), torch.from_numpy(psf), 3,
                                  fft_backend="matmul").numpy()
    assert ours.shape == shape and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= RL_INF
    # one plane, as JAX takes it
    one = richardson_lucy_planes(torch.from_numpy(y.reshape(-1, *shape[-2:])[0]),
                                 torch.from_numpy(psf), 3, fft_backend="matmul")
    ref_one = np.asarray(jax_rl(jnp.asarray(y.reshape(-1, *shape[-2:])[0]), jnp.asarray(psf), 3,
                                fft_backend="matmul"))
    assert one.shape == shape[-2:] and np.abs(one.numpy() - ref_one).max() <= RL_INF


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 3, 64, 96)])
def test_edge_taper_matmul_matches_jax(shape):
    psf = motion_blur_kernel_oracle(L, 45.0).astype(np.float32)
    live = (50, shape[-1] - 20)
    x = _planes(32, shape, live)
    ref = np.asarray(jax_edge_taper(jnp.asarray(x), jnp.asarray(psf), live, fft_backend="matmul"))
    ours = edge_taper_planes(torch.from_numpy(x), torch.from_numpy(psf), live,
                             fft_backend="matmul").numpy()
    assert ours.shape == shape and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= TAPER_REL * np.abs(ref).max()
    # the same blur as the kernel route's (its plain versions on the CPU;
    # 96 = 3 * 32 takes a radix-3 cross level there)
    rad = ((), (3,) if shape[-1] == 96 else ())
    kern = edge_taper_planes(torch.from_numpy(x), torch.from_numpy(psf), live,
                             radices_hw=rad).numpy()
    assert np.abs(ours - kern).max() <= TAPER_REL * np.abs(ref).max()


def test_generic_conv_matches_the_kernel_route():
    """conv and its conj twin through fft2d('matmul') against the kernel
    route's plain versions: the same circular convolution."""
    psf = torch.from_numpy(motion_blur_kernel_oracle(7, 60.0).astype(np.float32))
    re, im = (torch.from_numpy(_planes(s, (2, 64, 128))) for s in (33, 34))
    generic = convolve.circular_conv_builder(psf, 64, 128, fft_backend="matmul")
    kernel = convolve.circular_conv_builder(psf, 64, 128)
    for conj in (False, True):
        for a, b in zip(generic(re, im, conj), kernel(re, im, conj)):
            assert a.shape == (2, 64, 128)
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    with pytest.raises(ValueError, match="unknown fft backend"):
        convolve.circular_conv_builder(psf, 64, 128, fft_backend="cufft")


@pytest.mark.parametrize("kw", [dict(filter_name="rl", rl_iters=3),
                                dict(filter_name="rl", rl_iters=2, edgetaper=True)],
                         ids=["rl", "rl_edgetaper"])
def test_rl_pipeline_matmul_matches_jax(kw):
    img = _smooth_frames(35, 1, 64, 128)[0]  # fills its pow2 extent
    out_j, planes_j = JaxPipeline(fft_backend="matmul", **kw).restore_with_planes(
        img, L, ANGLE, K)
    out_t, planes_t = WienerDeblurPipeline("cpu", fft_backend="matmul", **kw
                                           ).restore_with_planes(img, L, ANGLE, K)
    assert planes_t.shape == (3, 64, 128) and out_t.shape == img.shape
    assert float(planes_t.min()) >= 0.0 and float(planes_t.max()) <= 1.0
    assert np.abs(planes_t - planes_j).max() <= RL_INF
    d_max, d_mean = _u8(out_t, out_j)
    assert d_max <= RL_U8_MAX and d_mean <= RL_U8_MEAN, (d_max, d_mean)


@pytest.mark.parametrize("filter_name", ["wiener", "cls"])
def test_edgetaper_pipeline_matmul_matches_jax(filter_name):
    img = _smooth_frames(36, 1, 40, 56)[0]
    out_j, planes_j = JaxPipeline(fft_backend="matmul", filter_name=filter_name,
                                  edgetaper=True).restore_with_planes(img, L, ANGLE, K)
    out_t, planes_t = WienerDeblurPipeline("cpu", fft_backend="matmul", filter_name=filter_name,
                                           edgetaper=True).restore_with_planes(img, L, ANGLE, K)
    assert np.abs(planes_t - planes_j).max() <= 1e-5
    assert _u8(out_t, out_j)[0] <= 1


@pytest.mark.parametrize("white_balance", [True, False])
def test_batched_matmul_matches_jax(white_balance):
    stack = (np.random.default_rng(37).random((4, 40, 56, 3)) * 255).astype(np.uint8)
    jax_pipe = JaxBatched(fft_backend="matmul", white_balance=white_balance)
    pipe = BatchedWienerPipeline("cpu", fft_backend="matmul", white_balance=white_balance)
    out_t = pipe.restore(stack, L, ANGLE, K)
    assert out_t.shape == stack.shape and out_t.dtype == np.uint8
    assert _u8(out_t, jax_pipe.restore(stack, L, ANGLE, K))[0] <= 1
    planes_t = pipe.restore_planes(stack, L, ANGLE, K)
    assert planes_t.shape == (4, 3, 40, 56)
    assert np.abs(planes_t - jax_pipe.restore_planes(stack, L, ANGLE, K)).max() <= 1e-5
    # no kernel route cache on the generic route, and each image as the
    # single pipeline restores it alone (pairs straddle images: 1 count)
    assert not pipe._psf_cache
    single = WienerDeblurPipeline("cpu", fft_backend="matmul", white_balance=white_balance)
    for i in range(len(stack)):
        assert _u8(out_t[i], single.restore(stack[i], L, ANGLE, K))[0] <= 1


def test_batched_rl_matmul_matches_jax():
    stack = _smooth_frames(38, 3, 64, 64)
    kw = dict(fft_backend="matmul", filter_name="rl", rl_iters=2, edgetaper=True)
    out_j = JaxBatched(**kw).restore(stack, 7, ANGLE, K)
    out_t = BatchedWienerPipeline("cpu", **kw).restore(stack, 7, ANGLE, K)
    d_max, d_mean = _u8(out_t, out_j)
    assert d_max <= RL_U8_MAX and d_mean <= RL_U8_MEAN, (d_max, d_mean)
