"""The generic restore route (fft_backend other than 'pallas') against the
JAX package's `WienerDeblurPipeline(fft_backend=...)` and the serial
oracle, on the CPU.

Tolerances: restored planes 1e-5 (inverse 2e-4: the filter divides by
|H|^2 down to its 1e-8 guard, so float32 rounding in the transforms is
amplified), uint8 within 1 count; `apply_filter` 1e-5 of the spectrum's
max magnitude (1e-4 with CLS on matmul and naive, whose Laplacian
spectrum sums in another order); against the oracle the l2, inf and gpu
tiers, as tests/test_pipeline.py holds the JAX backends.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.models import filters as jfilters
from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.models.pipeline import _pack_channel_pairs, _unpack_channel_pairs
from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline, deblur_image
from fft_restoration_tpu_torch.host.oracle import motion_psf, restore_channels
from fft_restoration_tpu_torch.host.verify import channels_equal
from fft_restoration_tpu_torch.models import filters as tfilters
from fft_restoration_tpu_torch.models import pipeline as tpipe

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

GENERIC = ("radix2", "matmul", "naive", "xla")
PLANES_TOL = {"wiener": 1e-5, "inverse": 2e-4, "cls": 1e-5}


def _frame(seed, h, w):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def _u8_max(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("filter_name", ["wiener", "inverse", "cls"])
@pytest.mark.parametrize("backend", GENERIC)
def test_generic_route_matches_jax(backend, filter_name):
    img = _frame(3, 40, 56)
    out_j, planes_j = JaxPipeline(fft_backend=backend, filter_name=filter_name
                                  ).restore_with_planes(img, 9, 30.0)
    out_t, planes_t = WienerDeblurPipeline("cpu", fft_backend=backend, filter_name=filter_name
                                           ).restore_with_planes(img, 9, 30.0)
    assert planes_t.shape == (3, 40, 56) and out_t.shape == img.shape
    assert np.abs(planes_t - planes_j).max() <= PLANES_TOL[filter_name]
    assert _u8_max(out_t, out_j) <= 1


@pytest.mark.parametrize("white_balance", [True, False])
def test_matmul_smooth_pad_matches_jax(white_balance):
    """--pad smooth on the generic route: 72x300 restores at 128x384,
    which matmul factors (384 = 24 * 16); the JAX pipeline at the same
    extents."""
    img = _frame(4, 72, 300)
    assert tpipe.pad_extents(72, 300, "smooth")[:2] == (128, 384)
    kw = dict(fft_backend="matmul", pad_mode="smooth", white_balance=white_balance)
    out_j, planes_j = JaxPipeline(**kw).restore_with_planes(img, 15, 20.0)
    out_t, planes_t = WienerDeblurPipeline("cpu", **kw).restore_with_planes(img, 15, 20.0)
    assert np.abs(planes_t - planes_j).max() <= 1e-5
    assert _u8_max(out_t, out_j) <= 1


@pytest.mark.parametrize("backend", GENERIC + ("pallas",))
def test_backends_match_oracle_tiers(backend):
    """Every backend's restored channels against the serial oracle at the
    l2, inf and gpu tiers (tests/test_pipeline.py's check of radix2 and
    matmul, at its 40x56 frame)."""
    img = _frame(5, 40, 56)
    ours = WienerDeblurPipeline("cpu", fft_backend=backend).restore_channels(img, 9, 30.0)
    oracle = restore_channels(np.moveaxis(img.astype(np.float32) / 255.0, -1, 0),
                              motion_psf(9, 30.0))
    for tier in ("l2", "inf", "gpu"):
        report = channels_equal(ours, oracle, tier)
        assert report.passed, f"{backend} {tier}: {report}"


@pytest.mark.parametrize("filter_name", ["wiener", "inverse", "cls"])
@pytest.mark.parametrize("backend", GENERIC + ("pallas",))
def test_apply_filter_matches_jax(backend, filter_name):
    rng = np.random.default_rng(6)
    g = [rng.standard_normal((2, 16, 32)).astype(np.float32) for _ in range(2)]
    h = [rng.standard_normal((16, 32)).astype(np.float32) for _ in range(2)]
    ref = [np.asarray(x) for x in jfilters.apply_filter(filter_name, g, h, 0.01, backend)]
    ours = tfilters.apply_filter(filter_name, [torch.from_numpy(x) for x in g],
                                 [torch.from_numpy(x) for x in h], 0.01, backend)
    tol = 1e-4 if filter_name == "cls" and backend in ("matmul", "naive") else 1e-5
    scale = max(np.abs(x).max() for x in ref)
    assert max(np.abs(o.numpy() - r).max() for o, r in zip(ours, ref)) <= tol * scale
    assert tfilters.FILTERS == jfilters.FILTERS
    with pytest.raises(ValueError, match="unknown filter"):
        tfilters.apply_filter("rl", ours, ours, 0.01)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_channel_pair_packing_matches_jax(c):
    x = np.random.default_rng(c).random((2, c, 4, 6)).astype(np.float32)
    ours = tpipe.pack_channel_pairs(torch.from_numpy(x))
    ref = _pack_channel_pairs(x)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tpipe.unpack_channel_pairs(*ours, c).numpy(),
                                  np.asarray(_unpack_channel_pairs(*ref, c)))


def test_generic_route_runs_no_psf_cache_and_no_kernels():
    """The generic route makes its PSF spectrum per call (the JAX pipeline
    caches it for 'pallas' only) and leaves the kernel route's cache empty."""
    pipe = WienerDeblurPipeline("cpu", fft_backend="matmul", emit_planes=False)
    out = pipe.restore(_frame(7, 40, 56), 9, 30.0)
    assert out.shape == (40, 56, 3) and not pipe._psf_cache
    with pytest.raises(ValueError, match="emit_planes=False"):
        pipe.restore_with_planes(_frame(7, 40, 56), 9, 30.0)


def test_deblur_image_is_the_pipeline():
    img = _frame(8, 40, 56)
    for backend in ("matmul", "pallas"):
        np.testing.assert_array_equal(
            deblur_image(img, 9, 30.0, device="cpu", fft_backend=backend),
            WienerDeblurPipeline("cpu", fft_backend=backend).restore(img, 9, 30.0))


@pytest.mark.parametrize("kw,item", [(dict(filter_name="rl"), "A3"), (dict(edgetaper=True), "A3")])
def test_unported_combinations_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        WienerDeblurPipeline("cpu", fft_backend="matmul", **kw)
    WienerDeblurPipeline("cpu", fft_backend="pallas", **kw)  # the kernel route takes them
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        BatchedWienerPipeline("cpu", fft_backend="matmul")
    with pytest.raises(ValueError, match="unknown fft backend"):
        WienerDeblurPipeline("cpu", fft_backend="cufft")
