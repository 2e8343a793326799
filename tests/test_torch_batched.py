"""The port's batched slice against the JAX package.

JAX: BatchedWienerPipeline / psf_grid_sweep with fft_backend="pallas" and
the batched post-processing kernels, all in interpret mode on the CPU.
Port: the same entry points on device="cpu", where every kernel wrapper
takes its plain version. Tolerances: restored planes <= 1e-5 max abs,
uint8 <= 1 count (the truncation edge), Lab-L partials rel 1e-5 of the
largest partial (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.batched import BatchedWienerPipeline as JaxBatched
from fft_restoration_tpu.models.batched import psf_grid_sweep as jax_sweep
from fft_restoration_tpu.ops.pallas import postprocess as jpp
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline, psf_grid_sweep
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels import postprocess as tpp

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

L, ANGLE, K = 15, 30.0, 0.01


def _stack(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return np.stack([
        blur_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), L, ANGLE) for _ in range(b)
    ])


def _u8_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


# --- B8a / B8b plain versions against the JAX batched kernels ----------------

PP_CASES = [  # (plane extent, live extent, stride, block_rows)
    ((256, 256), (200, 230), 1, 64),
    ((256, 256), (256, 256), 4, 8),
    ((512, 256), (300, 200), 4, 8),
]


def _raw_stack(rng, b, ext):
    """3B + 1 raw planes (a packed odd stack's phantom plane last), with
    per-plane offsets and scales, and their (lo, scale) over 3B planes."""
    raw = (rng.standard_normal((3 * b + 1,) + ext) * 40.0 + 7.0).astype(np.float32)
    raw += np.arange(3 * b + 1, dtype=np.float32)[:, None, None]
    lo = raw[: 3 * b].min(axis=(1, 2))
    scale = (1.0 / (raw[: 3 * b].max(axis=(1, 2)) - lo)).astype(np.float32)
    return raw, lo, scale


@pytest.mark.parametrize("ext,live,stride,block", PP_CASES)
def test_lab_l_partials_batched_match_jax(rng, ext, live, stride, block):
    b = 3
    raw, lo, scale = _raw_stack(rng, b, ext)
    frames = rng.integers(0, 256, (b,) + live + (3,), dtype=np.uint8)
    ref = np.asarray(jpp.lab_l_sum_partials_batched(
        jnp.asarray(raw), jnp.asarray(np.moveaxis(frames, -1, 1).reshape(3 * b, *live)), b,
        norm=(lo, scale), live_hw=live, stride=stride, block_rows=block,
    ))[..., :2]
    ours = tpp.lab_l_sum_partials_batched(
        torch.from_numpy(raw), torch.from_numpy(frames).permute(0, 3, 1, 2),
        torch.from_numpy(lo), torch.from_numpy(scale), live, stride, block,
    ).numpy()
    assert ours.shape == ref.shape == (b, ref.shape[1], 2)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    # B4 is the B = 1 case: image 1 alone, its planes first
    one = tpp.lab_l_sum_partials(
        torch.from_numpy(raw[3:6]), torch.from_numpy(frames[1]).permute(2, 0, 1),
        torch.from_numpy(lo[3:6]), torch.from_numpy(scale[3:6]), live, stride, block,
    ).numpy()
    assert np.abs(one - ref[1]).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("ext,live", [((256, 256), (256, 256)), ((256, 256), (200, 230))])
def test_wb_encode_batched_matches_jax(rng, ext, live):
    b = 3
    raw, lo, scale = _raw_stack(rng, b, ext)
    gains = np.array([0.93, 1.2, 1.05], np.float32)
    ref = np.asarray(jpp.wb_encode_u8_batched(
        jnp.asarray(raw), jnp.asarray(gains), b, norm=(lo, scale), live_hw=live,
    ))
    ours = tpp.wb_encode_u8_batched(
        torch.from_numpy(raw), torch.from_numpy(gains), torch.from_numpy(lo),
        torch.from_numpy(scale), live,
    ).numpy()
    assert ours.shape == (b,) + live + (3,) and ours.dtype == np.uint8
    assert _u8_diff(ours, np.moveaxis(ref.reshape(b, 3, *live), 1, -1)) <= 1
    one = tpp.wb_encode_u8(
        torch.from_numpy(raw[6:9]), torch.from_numpy(gains[2:]), torch.from_numpy(lo[6:9]),
        torch.from_numpy(scale[6:9]), live,
    ).numpy()
    assert np.array_equal(one, ours[2])


def test_batched_postprocess_rejects_bad_operands():
    raw = torch.zeros((7, 16, 16))
    lo = sc = torch.zeros(6)
    with pytest.raises(ValueError):  # lo/scale not a multiple of 3
        tpp.wb_encode_u8_batched(raw, torch.ones(2), lo[:5], sc[:5], (16, 16))
    with pytest.raises(ValueError):  # fewer planes than 3B
        tpp.lab_l_sum_partials_batched(raw[:5], torch.zeros((2, 3, 16, 16)), lo, sc, (16, 16))


# --- stack loader -------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2, 3])
def test_stack_loader_plain_is_channel_major_packing(rng, b):
    """Plane q of the loader's map is image q // 3, channel q % 3: the
    permute().reshape() of the stack, bitwise, split even/odd."""
    stack = torch.from_numpy(rng.integers(0, 256, (b, 20, 24, 3), dtype=np.uint8))
    flat = stack.permute(0, 3, 1, 2).reshape(3 * b, 20, 24)
    re, im = tfk.stack_pairs_plain(stack)
    assert torch.equal(re, flat[0::2]) and torch.equal(im, flat[1::2])
    ext = (32, 32)
    ours = tfk.fft_rows_stack(stack, extent=ext)
    ref = tfk.fft_rows_plain(flat[0::2], flat[1::2], transposed=True, extent=ext)
    for o, r in zip(ours, ref):
        assert o.shape == (-(-3 * b // 2), 32, 32)
        assert torch.equal(o, r)


def test_stack_loader_b1_is_the_frame_path(rng):
    """B = 1 gives bitwise what the single-frame channel-pair views give."""
    frame = torch.from_numpy(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
    c = frame.permute(2, 0, 1)
    ref = tfk.fft_rows(c[0::2], c[1::2], transposed=True, extent=(64, 128))
    ours = tfk.fft_rows_stack(frame[None], extent=(64, 128))
    for o, r in zip(ours, ref):
        assert torch.equal(o, r)
    with pytest.raises(ValueError):
        tfk.fft_rows_stack(frame, extent=(64, 128))
    with pytest.raises(ValueError):
        tfk.fft_rows_stack(frame[None], extent=(32, 128))


# --- the batched pipeline -----------------------------------------------------


@pytest.mark.parametrize(
    "b,h,w,stride",
    [(3, 128, 128, 1),   # hp = 128: the B7 middle
     (2, 150, 200, 1),   # ragged live extent
     (2, 300, 128, 4)],  # hp = 512: the B2 middle, strided statistics
)
def test_batched_matches_jax_pallas(b, h, w, stride):
    stack = _stack(b, h, w, seed=b * h + w)
    jax_pipe = JaxBatched(fft_backend="pallas", wb_stats_stride=stride)
    pipe = BatchedWienerPipeline("cpu", wb_stats_stride=stride)
    out_j = jax_pipe.restore(stack, L, ANGLE, K)
    out_t = pipe.restore(stack, L, ANGLE, K)
    assert out_t.shape == (b, h, w, 3) and out_t.dtype == np.uint8
    assert _u8_diff(out_t, out_j) <= 1
    planes_j = jax_pipe.restore_planes(stack, L, ANGLE, K)
    planes_t = pipe.restore_planes(stack, L, ANGLE, K)
    assert planes_t.shape == (b, 3, h, w) and planes_t.dtype == np.float32
    assert np.abs(planes_t - planes_j).max() <= 1e-5
    # each image as the single-frame pipeline restores it alone
    single = WienerDeblurPipeline("cpu", wb_stats_stride=stride)
    for i in range(b):
        assert _u8_diff(out_t[i], single.restore(stack[i], L, ANGLE, K)) <= 1


def test_batched_no_white_balance_and_serving_graph():
    stack = _stack(2, 128, 160, seed=3)
    out_j = JaxBatched(fft_backend="pallas", white_balance=False).restore(stack, L, ANGLE, K)
    out_t = BatchedWienerPipeline("cpu", white_balance=False).restore(stack, L, ANGLE, K)
    assert _u8_diff(out_t, out_j) <= 1
    serve = BatchedWienerPipeline("cpu", emit_planes=False)
    full = BatchedWienerPipeline("cpu")
    assert np.array_equal(serve.restore(stack, L, ANGLE, K), full.restore(stack, L, ANGLE, K))
    out, planes = serve.run(serve.to_device(stack), L, ANGLE, K)
    assert planes is None and tuple(out.shape) == stack.shape
    _, planes = full.run(full.to_device(stack), L, ANGLE, K)
    assert tuple(planes.shape) == (2, 3, 128, 160)


def test_psf_grid_sweep_matches_jax():
    img = _stack(1, 32, 32, seed=8)[0]
    lengths, angles = [3, 7], [0.0, 45.0]
    ref = jax_sweep(img, lengths, angles, K, fft_backend="pallas")
    ours = psf_grid_sweep(img, lengths, angles, K, device="cpu")
    assert ours.shape == ref.shape == (2, 2, 3, 32, 32)
    assert np.abs(ours - ref).max() <= 1e-5
    # one point as the batched pipeline restores it
    one = BatchedWienerPipeline("cpu").restore_planes(img[None], 7, 45.0, K)[0]
    assert np.array_equal(ours[1, 1], one)
    with pytest.raises(ValueError):
        psf_grid_sweep(img, [40], angles, K, device="cpu")


def test_batched_options_not_ported_raise():
    for name in ("inverse", "cls", "rl"):  # the filter family is ported
        assert BatchedWienerPipeline("cpu", filter_name=name, edgetaper=True).edgetaper
    smooth = BatchedWienerPipeline("cpu", pad_mode="smooth")  # ported: 64x300 at 64x384
    out = smooth.restore(_stack(2, 64, 300, 2), L, ANGLE, K)
    assert out.shape == (2, 64, 300, 3) and out.dtype == np.uint8
    with pytest.raises(NotImplementedError, match="A16"):  # bf16 staging, the next slice
        BatchedWienerPipeline("cpu", stage_dtype="bf16")
    with pytest.raises(ValueError):
        BatchedWienerPipeline("cpu").restore(_stack(2, 32, 32, 1)[0], 5, 0.0)


def test_batched_psf_type_gaussian_runs():
    stack = _stack(2, 64, 64, seed=4)
    jax_planes = JaxBatched(fft_backend="pallas", psf_type="gaussian").restore_planes(
        stack, 9, 2.0, K)
    ours = BatchedWienerPipeline("cpu", psf_type="gaussian").restore_planes(stack, 9, 2.0, K)
    assert np.abs(ours - jax_planes).max() <= 1e-5
