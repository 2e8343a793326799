"""Port white-balance post-processing (B4/B5) and color against JAX.

JAX: lab_l_sum_partials / wb_encode_u8 (Pallas, interpret mode on the
CPU) and the planar color functions. Port: the wrappers, which take the
plain versions for CPU tensors. Tolerances: partial sums rel 1e-5 of the
largest partial (float32 sums in another order), uint8 <= 1 count (the
truncation edge), color planes 1e-4 absolute (L in [0, 100]).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops import color as jcolor
from fft_restoration_tpu.ops.pallas import postprocess as jpp
from fft_restoration_tpu_torch.ops import color as tcolor
from fft_restoration_tpu_torch.ops.kernels import postprocess as tpp

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores


def _raw_and_norm(rng, c, hp, wp):
    """Raw planes with a per-channel offset/scale, like unscaled IFFT
    output, and their (lo, scale) normalize scalars."""
    raw = (rng.standard_normal((c, hp, wp)) * 40.0 + 7.0).astype(np.float32)
    lo = raw[:3].min(axis=(1, 2))
    hi = raw[:3].max(axis=(1, 2))
    return raw, lo, (1.0 / (hi - lo)).astype(np.float32)


CASES = [  # (plane extent, live extent, stride, block_rows)
    ((256, 256), (256, 256), 1, 64),
    ((256, 256), (200, 230), 1, 64),
    ((256, 512), (200, 300), 4, 8),
    ((512, 256), (300, 200), 4, 8),
]


@pytest.mark.parametrize("ext,live,stride,block", CASES)
def test_lab_l_partials_match_jax(rng, ext, live, stride, block):
    raw, lo, scale = _raw_and_norm(rng, 4, *ext)
    orig = rng.integers(0, 256, (3,) + live, dtype=np.uint8)
    ref = np.asarray(jpp.lab_l_sum_partials(
        jnp.asarray(raw), jnp.asarray(orig), norm=(lo, scale), live_hw=live,
        stride=stride, block_rows=block,
    ))[:, :2]
    # the original frame as the pipeline passes it: a (3, h, w) view of
    # an (h, w, 3) array
    frame = torch.from_numpy(np.ascontiguousarray(np.moveaxis(orig, 0, -1)))
    ours = tpp.lab_l_sum_partials(
        torch.from_numpy(raw), frame.permute(2, 0, 1), torch.from_numpy(lo),
        torch.from_numpy(scale), live, stride, block,
    ).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("ext,live", [((256, 256), (256, 256)), ((256, 256), (200, 230))])
@pytest.mark.parametrize("gain", [0.93, 1.2])
def test_wb_encode_matches_jax(rng, ext, live, gain):
    raw, lo, scale = _raw_and_norm(rng, 4, *ext)
    ref = np.asarray(jpp.wb_encode_u8(
        jnp.asarray(raw), gain, norm=(lo, scale), live_hw=live
    ))
    ours = tpp.wb_encode_u8(
        torch.from_numpy(raw), torch.tensor([gain], dtype=torch.float32),
        torch.from_numpy(lo), torch.from_numpy(scale), live,
    ).numpy()
    assert ours.shape == live + (3,) and ours.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - np.moveaxis(ref, 0, -1).astype(np.int32))
    assert diff.max() <= 1


def test_geometry_helpers_match_jax():
    for h in (1, 8, 63, 64, 255, 256, 257, 782, 1000, 2048, 4096):
        for stride in (1, 2, 4, 8):
            assert tpp.effective_wb_stride(h, stride) == jpp.effective_wb_stride(h, stride)
    for h0, w0 in ((256, 256), (1024, 2048), (4096, 8192), (128, 65536)):
        for live in ((h0, w0), (h0 - 7, w0 - 100), (h0 // 2 + 1, w0 // 3)):
            for block in (8, 64):
                assert tpp._block_geometry(h0, w0, block) == jpp._block_geometry(h0, w0, block)
                for stride in (1, 3, 4):
                    assert tpp.sampled_live_pixels(
                        h0, w0, live, block, stride
                    ) == jpp.sampled_live_pixels(h0, w0, live, block, stride)


def test_color_planar_matches_jax():
    # its own generator: drawn from the shared `rng` fixture, the planes
    # depended on the tests run before it, and some draws sat at the bound
    rng = np.random.default_rng(2024)
    b, g, r = (rng.random((64, 96)).astype(np.float32) for _ in range(3))
    jb, jg, jr = (jnp.asarray(x) for x in (b, g, r))
    tb, tg, tr = (torch.from_numpy(x) for x in (b, g, r))
    lab_j = jcolor.bgr_to_lab_planar(jb, jg, jr)
    lab_t = tcolor.bgr_to_lab_planar(tb, tg, tr)
    for o, x in zip(lab_t, lab_j):
        assert np.abs(o.numpy() - np.asarray(x)).max() <= 1e-4
    lum = tcolor.luminance_l_planar(tb, tg, tr).numpy()
    assert np.abs(lum - np.asarray(jcolor.luminance_l_planar(jb, jg, jr))).max() <= 1e-4
    back_j = jcolor.lab_to_bgr_planar(*lab_j)
    back_t = tcolor.lab_to_bgr_planar(*lab_t)
    for o, x, src in zip(back_t, back_j, (b, g, r)):
        assert np.abs(o.numpy() - np.asarray(x)).max() <= 1e-5
        assert np.abs(o.numpy() - src).max() <= 1e-4  # round trip


def test_rejects_bad_operands():
    raw = torch.zeros((4, 16, 16))
    lo = sc = torch.zeros(3)
    with pytest.raises(ValueError):
        tpp.wb_encode_u8(raw[:2], torch.ones(1), lo, sc, (16, 16))
    with pytest.raises(ValueError):
        tpp.lab_l_sum_partials(raw, torch.zeros((3, 16, 16)), lo, sc, (17, 16))
