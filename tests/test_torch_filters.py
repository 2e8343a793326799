"""The filter family through the port's pipelines: inverse, CLS and
Richardson-Lucy, and the edge taper on the batched path.

JAX: WienerDeblurPipeline(fft_backend="pallas") on the CPU (Pallas in
interpret mode). The port runs on the CPU, where every kernel wrapper
takes its plain version. Tolerances:
- the elementwise filters against ops/wiener.py of the JAX package,
  and CLS's Laplacian spectrum against the JAX pallas layout: 1e-6
  relative;
- CLS restored planes <= 1e-5, uint8 <= 1 count;
- inverse restored planes <= 2e-4, uint8 <= 1: the filter divides by
  |H|^2 down to its 1e-8 guard, so float32 rounding in the transforms
  is amplified up to 1e8 times; the JAX package's own two engines (mxu,
  roll) give planes 6.4e-5 apart on the same frame;
- RL (uint8 input, the pipeline's clip and planar white balance): the
  JAX package's RL contracts, 5e-2 plane INF, and uint8 at most 8
  counts with a mean of at most 0.2 (tests/test_richardson_lucy.py);
- batched against single: the JAX test's bounds for RL (the pairs
  straddle images), bit-exact for the last image of an odd stack;
  uint8 <= 1 for the one-shot filters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.models.pipeline import psf_spectrum_planes as jax_spectrum
from fft_restoration_tpu.ops import wiener as jwiener
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu_torch.models import pipeline as tpl
from fft_restoration_tpu_torch.models.batched import BatchedWienerPipeline
from fft_restoration_tpu_torch.ops import wiener as twiener

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

L, ANGLE, K = 15, 30.0, 0.01
RL_INF, RL_U8_MAX, RL_U8_MEAN = 5e-2, 8, 0.2
INVERSE_PLANES = 2e-4


def _u8(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float(d.mean())


def _smooth_frames(n, h, w, length=7):
    """Blurred block scenes on a grey floor (the JAX RL tests' frames,
    lifted off zero): where y and the blur of x both vanish, RL's
    y / (C(x) + eps) turns rounding into whole counts."""
    out = []
    for i in range(n):
        s = np.full((h, w, 3), 40, np.uint8)
        s[h // 7 + 5 * i: h * 2 // 3, w // 5: w // 2 + 5 * i] = 200
        s[h * 2 // 5: h // 2 + 2, w // 9: w * 5 // 6] = 120 + 20 * i
        s[..., 1] //= 2
        out.append(blur_image(s, length, 30.0))
    return np.stack(out)


def _spectra(rng):
    g = [rng.standard_normal((2, 16, 32)).astype(np.float32) for _ in range(2)]
    h = [rng.standard_normal((16, 32)).astype(np.float32) for _ in range(2)]
    h[0][0, :4] = 1e-5  # |H|^2 below the inverse filter's guard
    h[1][0, :4] = 0.0
    p = [rng.standard_normal((16, 32)).astype(np.float32) for _ in range(2)]
    return g, h, p


def _close(ours, ref, rel=1e-6):
    for o, r in zip(ours, ref):
        o, r = o.numpy(), np.asarray(r)
        assert np.abs(o - r).max() <= rel * np.abs(r).max()


def test_inverse_and_cls_filters_match_jax(rng):
    g, h, p = _spectra(rng)
    t = lambda xs: tuple(torch.from_numpy(x) for x in xs)  # noqa: E731
    j = lambda xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    inv = twiener.inverse_filter(t(g), t(h))
    _close(inv, jwiener.inverse_filter(j(g), j(h)))
    assert float(inv[0][:, 0, :4].abs().max()) == 0.0  # guarded to zero
    _close(twiener.cls_filter(t(g), t(h), t(p), 0.05), jwiener.cls_filter(j(g), j(h), j(p), 0.05))


@pytest.mark.parametrize("hp,wp", [(256, 128), (64, 32)])
def test_laplacian_spectrum_matches_jax_layout(hp, wp):
    lap = np.zeros((hp, wp), np.float32)
    lap[0, 0] = 4.0
    lap[0, 1] = lap[1, 0] = lap[0, -1] = lap[-1, 0] = -1.0
    ref = jax_spectrum(jnp.asarray(lap), hp, wp, engine="roll", psf_rows=hp)
    ours = tpl.laplacian_spectrum(hp, wp, torch.device("cpu"))
    assert ours[0].shape == (wp, hp)
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("filter_name,planes_tol", [("inverse", INVERSE_PLANES), ("cls", 1e-5)])
def test_one_shot_filters_match_jax_pipeline(rng, filter_name, planes_tol):
    img = blur_image(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8), L, ANGLE)
    out_j, planes_j = JaxPipeline(fft_backend="pallas", filter_name=filter_name
                                  ).restore_with_planes(img, L, ANGLE, K)
    out_t, planes_t = tpl.WienerDeblurPipeline("cpu", filter_name=filter_name
                                               ).restore_with_planes(img, L, ANGLE, K)
    assert planes_t.shape == (3, 256, 256) and out_t.dtype == np.uint8
    assert np.abs(planes_t - planes_j).max() <= planes_tol
    assert _u8(out_t, out_j)[0] <= 1


def test_rl_matches_jax_pipeline():
    # a frame that fills its pow2 extent: under a zero pad with no taper
    # the PSF's empty top rows read only the pad, y / (C + eps) there is
    # float32 rounding over eps, and any two float32 RLs part by ~0.1 (the
    # JAX package's own roll and mxu engines too); the padded frames are
    # held to the float64 RL in test_torch_richardson_lucy.py
    img = _smooth_frames(1, 256, 256)[0]
    out_j, planes_j = JaxPipeline(fft_backend="pallas", filter_name="rl", rl_iters=3
                                  ).restore_with_planes(img, L, ANGLE, K)
    out_t, planes_t = tpl.WienerDeblurPipeline("cpu", filter_name="rl", rl_iters=3
                                               ).restore_with_planes(img, L, ANGLE, K)
    assert planes_t.shape == (3, 256, 256)
    # clipped, not min-max normalized
    assert float(planes_t.min()) >= 0.0 and float(planes_t.max()) <= 1.0
    assert np.abs(planes_t - planes_j).max() <= RL_INF
    d_max, d_mean = _u8(out_t, out_j)
    assert d_max <= RL_U8_MAX and d_mean <= RL_U8_MEAN, (d_max, d_mean)


def test_rl_without_white_balance_is_the_clipped_planes():
    img = _smooth_frames(1, 72, 96)[0]
    pipe = tpl.WienerDeblurPipeline("cpu", filter_name="rl", rl_iters=2, white_balance=False)
    out, planes = pipe.restore_with_planes(img, 7, ANGLE)
    ref = np.clip(np.moveaxis(planes, 0, -1) * 255.0, 0, 255).astype(np.uint8)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("kw", [dict(filter_name="rl", rl_iters=4),
                                dict(filter_name="rl", rl_iters=2, edgetaper=True)],
                         ids=["rl", "rl_edgetaper"])
def test_batched_rl_matches_single(kw):
    stack = _smooth_frames(3, 72, 96)
    batched = BatchedWienerPipeline("cpu", **kw).restore(stack, 7, ANGLE)
    single = tpl.WienerDeblurPipeline("cpu", **kw)
    assert batched.shape == stack.shape and batched.dtype == np.uint8
    for i in range(len(stack)):
        d_max, d_mean = _u8(batched[i], single.restore(stack[i], 7, ANGLE))
        assert d_max <= RL_U8_MAX and d_mean <= RL_U8_MEAN, (i, d_max, d_mean)
    assert d_max == 0  # last image of an odd stack: aligned pairing, bit-exact


@pytest.mark.parametrize("kw,planes_tol", [(dict(edgetaper=True), 1e-5),
                                           (dict(filter_name="inverse"), INVERSE_PLANES),
                                           (dict(filter_name="cls", edgetaper=True), 1e-5)],
                         ids=["edgetaper", "inverse", "cls_edgetaper"])
def test_batched_one_shot_filters_match_single(rng, kw, planes_tol):
    stack = np.stack([blur_image(rng.integers(0, 256, (130, 140, 3), dtype=np.uint8), L, ANGLE)
                      for _ in range(3)])
    pipe = BatchedWienerPipeline("cpu", **kw)
    batched = pipe.restore(stack, L, ANGLE, K)
    planes = pipe.restore_planes(stack, L, ANGLE, K)
    single = tpl.WienerDeblurPipeline("cpu", **kw)
    for i in range(len(stack)):
        out, ref_planes = single.restore_with_planes(stack[i], L, ANGLE, K)
        assert _u8(batched[i], out)[0] <= 1
        assert np.abs(planes[i] - ref_planes).max() <= planes_tol


def test_unknown_filter_raises():
    with pytest.raises(ValueError, match="unknown filter"):
        tpl.WienerDeblurPipeline("cpu", filter_name="lucy")
    with pytest.raises(ValueError, match="unknown filter"):
        BatchedWienerPipeline("cpu", filter_name="lucy")
