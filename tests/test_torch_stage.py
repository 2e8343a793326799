"""bf16 staging (stage_dtype="bf16") of the port against the JAX package's.

Kernel level: each bfloat16 store and load variant's plain twin against
the JAX kernel with out_dtype=jnp.bfloat16 or bfloat16 inputs, in
interpret mode, from the same numpy inputs, at roll and at mxu (the JAX
package computes its mxu group products in float32 on a CPU, so the
port's side runs mxu_precision="highest", as tests/test_torch_mxu_engine.py
does). A bfloat16 output is held to one bfloat16 step of each value beyond the
float32 tolerance: the two sides' float32 values differ only by the
order of their sums (1e-5 of the plane's max), so a value beside a
rounding edge may land on either neighbour. A float32
output read from the same bfloat16 inputs is held to 1e-5 of the plane's
max, as the float32 kernels are.

Pipeline level: JAX's own bounds (tests/test_pipeline.py, the gpu tier
and > 50 dB against float32 staging; tests/test_batched.py, not
bit-identical, > 50 dB, <= 2 counts) on the port, and the port's staged
restores against JAX's at mxu (where the two pick the same middle), with
the H dtype each class feeds its kernels: the single-frame pipeline's
cached bfloat16 spectrum, the batched pipeline's float32 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.batched import BatchedWienerPipeline as JaxBatched
from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.models.pipeline import psf_spectrum_planes as jax_spectrum
from fft_restoration_tpu.models.pipeline import restore_planes as jax_restore_planes
from fft_restoration_tpu.ops import wiener as jwiener
from fft_restoration_tpu.ops.pallas import fft_kernel as jfk
from fft_restoration_tpu.ops.pallas import wiener_spectral as jws
from fft_restoration_tpu.ops.psf import motion_blur_kernel
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu.oracle.serial import restore_channels
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu.utils.verify import channels_equal
from fft_restoration_tpu_torch import cli
from fft_restoration_tpu_torch.models import batched as tbatched
from fft_restoration_tpu_torch.models import pipeline as tpl
from fft_restoration_tpu_torch.ops import wiener as twiener
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as tws
from fft_restoration_tpu_torch.ops.psf import make_psf

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

REL = 1e-5
B16 = torch.bfloat16
ENGINES = {"roll": (dict(engine="roll"), dict()),
           "mxu": (dict(engine="mxu"), dict(engine="mxu", precision="highest"))}
K = 0.01


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _bf16_steps(ours, ref, rel=REL) -> float:
    """The largest |ours - ref| less the float32 tolerance (rel of the
    plane's max: the two sides' float32 values before the rounding), in
    bfloat16 steps of the larger of the two magnitudes (2^(e - 7) for a
    value in [2^e, 2^(e+1)))."""
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.finfo(np.float32).tiny)
    off = np.maximum(np.abs(a - b) - rel * float(np.abs(b).max()), 0.0)
    return float((off / np.exp2(np.floor(np.log2(mag)) - 7)).max())


def _close(ours, ref, rel=REL):
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, (err, scale)


def _bf16_out(ours, ref):
    """A bfloat16 store on both sides, within one bfloat16 step."""
    for o, r in zip(ours, ref):
        assert o.dtype == B16 and r.dtype == jnp.bfloat16
        assert _bf16_steps(o, r) <= 1.0


def _psnr(a, b) -> float:
    mse = float(((np.asarray(a) - np.asarray(b)) ** 2).mean())
    return 10 * np.log10(1.0 / max(mse, 1e-30))


def _u8_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _spectral_operands(rng, p, m, n, engine):
    """A row-FFT'd stack and a PSF spectrum from the JAX forward pass at
    `engine` (numpy float32), as the pipeline feeds the middles."""
    a = rng.standard_normal((p, m, n)).astype(np.float32)
    h = rng.random((m, n)).astype(np.float32) / (m * n) ** 0.5
    ar, ai = jfk.fft_rows_pallas(jnp.asarray(a), None, False, ordering="revorder",
                                 engine=engine)
    hr, hi = jfk.fft_rows_pallas(jnp.asarray(h), None, False, ordering="revorder",
                                 engine=engine)
    return [np.asarray(x) for x in (ar, ai, hr, hi)]


def _jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# kernel level


@pytest.mark.parametrize("engine", ENGINES)
def test_b1_bf16_store_matches_jax(engine):
    """B1's bfloat16 store: the uint8 packed planes (the frame's pairs and
    the stack loader), a float pair, a single plane."""
    jkw, tkw = ENGINES[engine]
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (4, 40, 256), dtype=np.uint8)
    ref = jfk.fft_rows_pallas(jnp.asarray(x), None, False, ordering="revorder",
                              transposed_output=True, packed_planes=True,
                              out_dtype=jnp.bfloat16, **jkw)
    t = torch.from_numpy(x)
    _bf16_out(tfk.fft_rows(t[0::2], t[1::2], transposed=True, out_dtype=B16, **tkw), ref)
    stack = rng.integers(0, 256, (2, 40, 200, 3), dtype=np.uint8)
    planes = np.zeros((6, 128, 256), np.uint8)
    planes[:, :40, :200] = np.moveaxis(stack, -1, 1).reshape(6, 40, 200)
    ref = jfk.fft_rows_pallas(jnp.asarray(planes), None, False, ordering="revorder",
                              transposed_output=True, packed_planes=True,
                              out_dtype=jnp.bfloat16, **jkw)
    ours = tfk.fft_rows_stack(torch.from_numpy(stack), extent=(128, 256), out_dtype=B16, **tkw)
    _bf16_out(ours, ref)
    re = rng.standard_normal((2, 48, 256)).astype(np.float32)
    im = rng.standard_normal((2, 48, 256)).astype(np.float32)
    ref = jfk.fft_rows_pallas(jnp.asarray(re), jnp.asarray(im), False, ordering="revorder",
                              transposed_output=True, out_dtype=jnp.bfloat16, **jkw)
    _bf16_out(tfk.fft_rows(_t(re), _t(im), transposed=True, out_dtype=B16, **tkw), ref)
    ref = jfk.fft_rows_pallas(jnp.asarray(re[:1]), None, False, ordering="revorder",
                              transposed_output=True, out_dtype=jnp.bfloat16, **jkw)
    _bf16_out(tfk.fft_rows(_t(re[:1]), None, transposed=True, out_dtype=B16, **tkw), ref)


@pytest.mark.parametrize("mode", ["wiener", "wiener_h_f32", "conv", "conv_conj"])
@pytest.mark.parametrize("engine", ENGINES)
def test_b2_bf16_variants_match_jax(engine, mode):
    """B2: 'wiener' loads bfloat16 A and H (or a float32 H) and stores
    bfloat16; 'conv' and conj load a bfloat16 H (the JAX package negates
    H_im for the conj)."""
    jkw, tkw = ENGINES[engine]
    ar, ai, hr, hi = _spectral_operands(np.random.default_rng(2), 2, 128, 256, engine)
    if mode.startswith("wiener"):
        h = (hr, hi) if mode == "wiener_h_f32" else (_jb(hr), _jb(hi))
        ref = jws.wiener_spectral_rows_t((_jb(ar), _jb(ai)), tuple(jnp.asarray(x) for x in h),
                                         K, out_dtype=jnp.bfloat16, **jkw)
        th = [_t(x) for x in (hr, hi)] if mode == "wiener_h_f32" else [
            _t(x).to(B16) for x in (hr, hi)]
        ours = tws.wiener_spectral_t(_t(ar).to(B16), _t(ai).to(B16), *th, K, out_dtype=B16,
                                     **tkw)
        _bf16_out(ours, ref)
    else:
        conj = mode == "conv_conj"
        hb = (_jb(hr), -_jb(hi) if conj else _jb(hi))
        ref = jws.wiener_spectral_rows_t((jnp.asarray(ar), jnp.asarray(ai)), hb, 0.0,
                                         spectral_filter="conv", **jkw)
        ours = tws.spectral_conv_t(_t(ar), _t(ai), _t(hr).to(B16), _t(hi).to(B16), conj,
                                   **tkw)
        for o, r in zip(ours, ref):
            assert o.dtype == torch.float32
            _close(o, r)


@pytest.mark.parametrize("h_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("engine", ENGINES)
def test_b7_bf16_loads_match_jax(engine, h_dtype):
    """B7 loads bfloat16 A with a bfloat16 or float32 H, stores float32."""
    jkw, tkw = ENGINES[engine]
    ar, ai, hr, hi = _spectral_operands(np.random.default_rng(3), 3, 64, 256, engine)
    jh = (_jb(hr), _jb(hi)) if h_dtype == "bf16" else (jnp.asarray(hr), jnp.asarray(hi))
    ref = jws.fwd_wiener_rows_pallas((_jb(ar), _jb(ai)), jh, K, **jkw)
    th = [_t(x).to(B16) if h_dtype == "bf16" else _t(x) for x in (hr, hi)]
    ours = tws.fwd_wiener_rows(_t(ar).to(B16), _t(ai).to(B16), *th, K, **tkw)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        _close(o, r)


@pytest.mark.parametrize("engine", ENGINES)
def test_b6_and_b3_bf16_loads_match_jax(engine):
    """B6's forward pass (inverse / CLS) and B3's packed last pass read
    bfloat16 planes; both store float32 (B3 its min/max too)."""
    jkw, tkw = ENGINES[engine]
    rng = np.random.default_rng(4)
    re = rng.standard_normal((2, 16, 256)).astype(np.float32)
    im = rng.standard_normal((2, 16, 256)).astype(np.float32)
    ref = jfk.fft_rows_pallas(_jb(re), _jb(im), False, ordering="revorder", **jkw)
    ours = tfk.fft_rows(_t(re).to(B16), _t(im).to(B16), **tkw)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        _close(o, r)
    out_j, mm_j = jfk.fft_rows_packed_out(_jb(re), _jb(im), True, ordering="revorder",
                                          emit_minmax=True, **jkw)
    out_t, mm_t = tfk.fft_rows_packed_out(_t(re).to(B16), _t(im).to(B16), **tkw)
    assert out_t.dtype == torch.float32
    _close(out_t, out_j)
    per_j, per_t = np.asarray(mm_j).reshape(2, -1, 4), mm_t.numpy().reshape(2, -1, 4)
    for col, red in ((0, np.min), (1, np.max), (2, np.min), (3, np.max)):
        _close(red(per_t[..., col], -1), red(per_j[..., col], -1))


def test_bf16_operands_outside_the_instances_raise():
    """The variants the pipelines reach, and no others (as the C entries)."""
    f = torch.zeros((2, 16, 256))
    b = f.to(B16)
    h = torch.zeros((16, 256))
    with pytest.raises(ValueError, match="transposed"):
        tfk.fft_rows(f, f, out_dtype=B16)
    with pytest.raises(ValueError, match="forward"):
        tfk.fft_rows(f, f, inverse=True, transposed=True, out_dtype=B16)
    with pytest.raises(ValueError, match="bf16 staging"):
        tfk.fft_rows(b, b, transposed=True)
    with pytest.raises(ValueError, match="bf16 staging"):
        tfk.fft_rows(b[:, :, :16], b[:, :, :16], ordering="natural")
    with pytest.raises(ValueError, match="out_dtype"):
        tfk.fft_rows(f, f, transposed=True, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no instance"):  # B2 'wiener': A and out together
        tws.wiener_spectral_t(b, b, h, h, K)
    with pytest.raises(ValueError, match="no instance"):
        tws.wiener_spectral_t(f, f, h, h, K, out_dtype=B16)
    with pytest.raises(ValueError, match="no instance"):  # 'conv': H alone
        tws.spectral_conv_t(b, b, h, h)
    with pytest.raises(ValueError, match="no instance"):  # B7: A bfloat16
        tws.fwd_wiener_rows(f, f, h.to(B16), h.to(B16), K)


def test_bf16_filters_match_jax_under_jit():
    """inverse and CLS on a bfloat16 H compute as the JAX filters under jit
    on a CPU (the pipeline's graph): the squares of |H|^2 rounded to
    bfloat16, their sum float32, the inverse's 1 / |H|^2 rounded; eager
    per-op bfloat16 rounding of the sum misses CLS by far more."""
    rng = np.random.default_rng(5)
    g = [rng.standard_normal((64, 64)).astype(np.float32) for _ in range(2)]
    h = [rng.standard_normal((64, 64)).astype(np.float32) for _ in range(2)]
    p = [rng.standard_normal((64, 64)).astype(np.float32) for _ in range(2)]
    jg, jh, jp = [jnp.asarray(x) for x in g], [_jb(x) for x in h], [jnp.asarray(x) for x in p]
    tg, th, tp = [_t(x) for x in g], [_t(x).to(B16) for x in h], [_t(x) for x in p]
    j_inv = jax.jit(jwiener.inverse_filter)(jg, jh)
    j_cls = jax.jit(jwiener.cls_filter)(jg, jh, jp, 0.01)
    for ours, ref in ((twiener.inverse_filter(tg, th), j_inv),
                      (twiener.cls_filter(tg, th, tp, 0.01), j_cls)):
        for o, r in zip(ours, ref):
            assert o.dtype == torch.float32
            _close(o, r, 1e-6)
    # a float32 H is untouched by the bfloat16 rule
    f_inv = twiener.inverse_filter(tg, [x.float() for x in th])
    ref = jwiener.inverse_filter(jg, [x.astype(jnp.float32) for x in jh])
    for o, r in zip(f_inv, ref):
        _close(o, r, 1e-6)


# ---------------------------------------------------------------------------
# pipeline level: JAX's bounds on the port


def test_bf16_staged_restore_planes_gpu_tier_and_50db():
    """tests/test_pipeline.py's bounds on the port's restore_planes and
    single-frame pipeline (the same frames)."""
    rng = np.random.default_rng(3)
    chans = rng.random((3, 256, 256)).astype(np.float32)
    psf = make_psf("motion", 15, 45.0, "cpu")
    f32 = tpl.restore_planes(_t(chans), psf, K).numpy()
    b16 = tpl.restore_planes(_t(chans), psf, K, stage_dtype="bf16").numpy()
    assert np.abs(b16 - f32).max() > 0.0  # the option took effect
    report = channels_equal(b16, f32, "gpu")
    assert report.passed, str(report)
    assert _psnr(f32, b16) > 50.0

    img = (rng.random((150, 200, 3)) * 255).astype(np.uint8)
    ours = tpl.WienerDeblurPipeline("cpu", stage_dtype="bf16").restore_channels(img, 9, 30.0)
    oracle = restore_channels(np.moveaxis(img.astype(np.float32) / 255.0, -1, 0),
                              motion_blur_kernel_oracle(9, 30.0))
    report = channels_equal(ours, oracle, "gpu")
    assert report.passed, str(report)


def test_stage_dtype_rejects_unknown():
    psf = make_psf("motion", 9, 30.0, "cpu")
    with pytest.raises(ValueError, match="stage_dtype"):
        tpl.restore_planes(torch.zeros((3, 128, 128)), psf, K, stage_dtype="fp8")
    with pytest.raises(ValueError, match="stage_dtype"):
        tpl.WienerDeblurPipeline("cpu", stage_dtype="fp8")
    with pytest.raises(ValueError, match="stage_dtype"):
        tbatched.BatchedWienerPipeline("cpu", stage_dtype="fp8")
    with pytest.raises(ValueError, match="stage_dtype"):
        tbatched.psf_grid_sweep(np.zeros((64, 64, 3), np.uint8), [5], [0.0], device="cpu",
                                stage_dtype="fp8")
    for ok in (None, "f32", "float32", "bf16", "bfloat16"):
        tpl.stage_of(ok)


def test_batched_stage_dtype_bf16_bounds(rng):
    """tests/test_batched.py's test on the port: the option reaches the
    kernels (not bit-identical), > 50 dB and <= 2 counts of float32
    staging."""
    stack = (rng.random((2, 128, 128, 3)) * 255).astype(np.uint8)
    f32 = tbatched.BatchedWienerPipeline("cpu").restore_planes(stack, 9, 30.0)
    b16 = tbatched.BatchedWienerPipeline("cpu", stage_dtype="bf16").restore_planes(
        stack, 9, 30.0)
    assert np.abs(b16 - f32).max() > 0.0
    assert _psnr(f32, b16) > 50.0
    out_f32 = tbatched.BatchedWienerPipeline("cpu").restore(stack, 9, 30.0)
    out_b16 = tbatched.BatchedWienerPipeline("cpu", stage_dtype="bf16").restore(stack, 9, 30.0)
    assert _u8_diff(out_b16, out_f32) <= 2
    sweep_f = tbatched.psf_grid_sweep(stack[0], [5, 9], [0.0, 30.0], device="cpu")
    sweep_b = tbatched.psf_grid_sweep(stack[0], [5, 9], [0.0, 30.0], device="cpu",
                                      stage_dtype="bf16")
    assert np.abs(sweep_b - sweep_f).max() > 0.0 and _psnr(sweep_f, sweep_b) > 50.0


# ---------------------------------------------------------------------------
# the port's staged restores against JAX's (mxu: both pick B7 at 256^2, the
# same route; the H dtype each class uses)

MXU = dict(fft_engine="mxu", mxu_precision="highest")


def _frame(seed, h=256, w=256):
    rng = np.random.default_rng(seed)
    return blur_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 9, 30.0)


# planes within STAGE_PLANES of JAX's and uint8 within 1 count: both sides
# store the same float32 spectrum (to 1e-5) as bfloat16, and a value
# beside a rounding edge may land a step apart (2^-8 of itself), which the
# filter's gain carries into the planes. These frames read planes 9.5e-5
# (wiener), 1.19e-3 (inverse: 1 / |H|^2), 7.0e-5 (CLS), batched 1.06e-4,
# against 2.7e-6 / 6.3e-5 / 2.6e-6 without staging; 1 count each
STAGE_PLANES = {"wiener": 5e-4, "inverse": 5e-3, "cls": 5e-4}


@pytest.mark.parametrize("filter_name", ["wiener", "inverse", "cls"])
def test_single_frame_bf16_matches_jax(filter_name):
    """WienerDeblurPipeline(stage_dtype='bf16'): the cached bfloat16 H in
    both packages, every filter reading it."""
    img = _frame(7)
    jp = JaxPipeline(fft_backend="pallas", stage_dtype="bf16", filter_name=filter_name)
    tp = tpl.WienerDeblurPipeline("cpu", stage_dtype="bf16", filter_name=filter_name, **MXU)
    j_out, j_planes = jp.restore_with_planes(img, 9, 30.0, K)
    t_out, t_planes = tp.restore_with_planes(img, 9, 30.0, K)
    assert np.abs(t_planes - j_planes).max() <= STAGE_PLANES[filter_name]
    assert _u8_diff(t_out, j_out) <= 1
    assert tp._psf_spectrum(256, 256, 9, 30.0)[1][0].dtype == B16


def test_batched_bf16_matches_jax():
    """BatchedWienerPipeline(stage_dtype='bf16'): H float32 in both."""
    stack = np.stack([_frame(8), _frame(9)])
    j = JaxBatched(fft_backend="pallas", stage_dtype="bf16").restore_planes(stack, 9, 30.0, K)
    t = tbatched.BatchedWienerPipeline("cpu", stage_dtype="bf16", **MXU)
    ours = t.restore_planes(stack, 9, 30.0, K)
    assert np.abs(ours - np.asarray(j)).max() <= STAGE_PLANES["wiener"]
    assert t._psf_spectrum(256, 256, 9, 30.0)[1][0].dtype == torch.float32


def test_rl_ignores_stage_dtype():
    """Richardson-Lucy's planes are not staged (JAX returns before reading
    the option): restore_planes gives the same planes either way, and so
    does JAX's; the two packages agree."""
    chans = np.random.default_rng(10).random((3, 128, 128)).astype(np.float32)
    psf = make_psf("motion", 9, 30.0, "cpu")
    ours = [tpl.restore_planes(_t(chans), psf, K, filter_name="rl", rl_iters=3,
                               stage_dtype=s, **MXU).numpy() for s in ("f32", "bf16")]
    assert np.array_equal(ours[0], ours[1])
    jpsf = motion_blur_kernel(9, jnp.float32(30.0))
    refs = [np.asarray(jax_restore_planes(jnp.asarray(chans), jpsf, K, fft_backend="pallas",
                                          filter_name="rl", rl_iters=3, stage_dtype=s))
            for s in ("f32", "bf16")]
    assert np.array_equal(refs[0], refs[1])
    assert np.abs(ours[1] - refs[1]).max() <= 1e-4


# ---------------------------------------------------------------------------
# the spectrum: which H each class feeds its kernels, the caches' keys, a
# spectrum carried from JAX


def test_spectrum_dtype_per_class_and_cache_keys():
    single = tpl.WienerDeblurPipeline("cpu", stage_dtype="bf16")
    single_f = tpl.WienerDeblurPipeline("cpu")
    batched = tbatched.BatchedWienerPipeline("cpu", stage_dtype="bf16")
    assert single.spectrum_dtype == B16 and single_f.spectrum_dtype == torch.float32
    assert batched.spectrum_dtype == torch.float32
    pad = single.pad(100, 120)
    # an f32 and a bf16 pipeline never share a spectrum
    assert single._cache_key(pad, 9, 30.0) != single_f._cache_key(pad, 9, 30.0)
    assert batched._cache_key(pad, 9, 30.0) == single_f._cache_key(pad, 9, 30.0)
    h_b = single._psf_spectrum(100, 120, 9, 30.0)[1]
    h_f = single_f._psf_spectrum(100, 120, 9, 30.0)[1]
    assert h_b[0].dtype == B16 and h_f[0].dtype == torch.float32
    assert torch.equal(h_b[0], h_f[0].to(B16))  # cast once from the float32 spectrum
    assert batched._psf_spectrum(100, 120, 9, 30.0)[1][0].dtype == torch.float32


def test_jax_bf16_spectrum_loads_exactly():
    """psf_spectrum_from_numpy takes a JAX bfloat16 spectrum (widened
    exactly) and load_psf_spectrum stores it in the pipeline's own dtype:
    the bfloat16 values come back bit for bit."""
    jpsf = motion_blur_kernel(9, jnp.float32(30.0))
    hb = jax_spectrum(jpsf, 128, 128, engine="roll", stage_dtype="bf16")
    assert hb[0].dtype == jnp.bfloat16
    h = tpl.psf_spectrum_from_numpy(*hb, "cpu")
    assert h[0].dtype == torch.float32
    assert np.array_equal(h[0].numpy(), np.asarray(hb[0], np.float32))
    pipe = tpl.WienerDeblurPipeline("cpu", stage_dtype="bf16")
    pipe.load_psf_spectrum(100, 120, 9, 30.0, hb)
    got = pipe._psf_spectrum(100, 120, 9, 30.0)[1]
    assert got[0].dtype == B16
    for g, r in zip(got, hb):
        assert np.array_equal(g.float().numpy(), np.asarray(r, np.float32))
    # the port's own bfloat16 spectrum is JAX's at roll (to a bfloat16 step)
    ours = tpl.psf_spectrum_planes(make_psf("motion", 9, 30.0, "cpu"), 128, 128,
                                   stage_dtype="bf16")
    for o, r in zip(ours, hb):
        assert _bf16_steps(o, r) <= 1.0


def test_cli_stage_dtype_in_tiled_mode_is_ignored(tmp_path, capsys):
    """The JAX CLI's tiled-mode note for --stage-dtype bf16."""
    from fft_restoration_tpu_torch.host.imageio import imwrite

    img = _frame(12, 90, 140)
    path = tmp_path / "f.png"
    imwrite(str(path), img)
    rc = cli.main([str(path), "9", "30", "--device", "cpu", "--tile", "128", "--stage-dtype",
                   "bf16", "-o", str(tmp_path / "o.png")])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "[INFO] --stage-dtype is not supported in tiled mode; ignored" in text
