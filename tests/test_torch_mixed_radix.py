"""The port's mixed-radix transforms (B-mixed) and --pad smooth against the
JAX package.

JAX: the Pallas kernels in interpret mode on the CPU with engine="roll"
and ordering="revorder" (the port's spectrum order: residue blocks,
bit-reversed inside each q-block), and the pipelines with
fft_backend="pallas". Port: the plain versions (every wrapper takes them
for CPU tensors). Tolerances: kernels 1e-5 of the plane's max magnitude
(float32 sums in another order); restored planes 1e-4 and uint8 1 count
against JAX; 2e-4 against a float64 np.fft restore at the same extents;
the serial oracle's naive DFT at the same extents at the inf tier once
both sides share one normalization (test_oracle_pad_to_matches_the_port);
RL 5e-2 (its contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.batched import BatchedWienerPipeline as JaxBatched
from fft_restoration_tpu.models.edgetaper import edge_taper_planes as jax_edge_taper
from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.models.richardson_lucy import richardson_lucy_planes as jax_rl
from fft_restoration_tpu.ops.pallas import fft_kernel as jfk
from fft_restoration_tpu.ops.pallas.wiener_spectral import (
    fwd_wiener_rows_pallas,
    wiener_spectral_rows_t,
)
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu_torch import BatchedWienerPipeline, WienerDeblurPipeline, cli
from fft_restoration_tpu_torch.host import oracle
from fft_restoration_tpu_torch.models import pipeline as tpl
from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes
from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as tws

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

SMOOTH = [(384, (3,)), (640, (5,)), (1152, (3, 3)), (1920, (3, 5))]
REL = 1e-5
L, ANGLE, K = 15, 30.0, 0.01


def _close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rel * max(float(np.abs(ref).max()), 1e-30)


def _t(x):
    return torch.from_numpy(np.array(x))


def _stack(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return np.stack([blur_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), L, ANGLE)
                     for _ in range(b)])


def _u8_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


# --- tables and lengths ---------------------------------------------------------


@pytest.mark.parametrize("n,rad", SMOOTH)
def test_tables_match_jax_bitwise(n, rad):
    q = tfk._mixed_q(n, rad)
    assert q == jfk._mixed_q(n, rad) and tfk.check_length(n, rad) == q.bit_length() - 1
    for inverse in (False, True):
        for a, b in zip(tfk._twiddle_planes_np(n, inverse, q),
                        jfk._twiddle_planes_np(n, inverse, q)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tfk._cross_planes_np(n, rad, inverse),
                        jfk._cross_planes_np(n, rad, inverse)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfk._half_masks_np(n, q), jfk._half_masks_np(n, q))
    t = tfk.tables(n, True, torch.device("cpu"), rad)
    assert t.cos.shape == (q.bit_length() - 1, n) and t.xcos.shape == (len(rad), n)


def test_length_and_radix_errors():
    with pytest.raises(ValueError, match="do not divide"):
        tfk.check_length(384, (7,))
    with pytest.raises(ValueError, match="non-power-of-two tail"):
        tfk.check_length(1920, (3,))
    with pytest.raises(ValueError, match="power-of-two"):
        tfk.fft_rows(torch.zeros((1, 8, 384)))  # a smooth length needs its radices
    with pytest.raises(ValueError, match="non-power-of-two tail"):
        tfk.fft_rows(torch.zeros((1, 8, 1920)), radices=(3,))
    # the CUDA kernels' cross levels: radix 3 or 5, at most two levels
    for rad in ((7,), (3, 3, 5), (2,)):
        with pytest.raises(ValueError, match="CUDA kernels"):
            tfk._cross_plan_host(rad, False)
    levels, radix, coef = tfk._cross_plan_host((3, 5), True)
    assert levels == 2 and list(radix) == [3, 5]
    np.testing.assert_array_equal(coef[1, 0, :5], tfk._cross_coefs_np(5, True)[0])
    with pytest.raises(ValueError, match="unknown pad mode"):
        tpl.pad_extents(10, 10, "pow3")
    with pytest.raises(ValueError, match="unknown pad mode"):
        WienerDeblurPipeline("cpu", pad_mode="even")


# --- the row-FFT family (B1/B3/B6) with cross levels ------------------------------


@pytest.mark.parametrize("transposed", [False, True], ids=["natural", "T"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n,rad", SMOOTH)
def test_fft_rows_matches_jax_roll(n, rad, inverse, transposed):
    rng = np.random.default_rng(n + 2 * inverse + transposed)
    re = rng.standard_normal((8, n)).astype(np.float32)
    im = rng.standard_normal((8, n)).astype(np.float32)
    ref = jfk.fft_rows_pallas(jnp.asarray(re), jnp.asarray(im), inverse, ordering="revorder",
                              transposed_output=transposed, engine="roll", radices=rad)
    ours = tfk.fft_rows(_t(re)[None], _t(im)[None], inverse=inverse, transposed=transposed,
                        radices=rad)
    for o, r in zip(ours, ref):
        _close(o[0], r)


def test_forward_then_inverse_is_n_times_identity():
    rng = np.random.default_rng(3)
    for n, rad in SMOOTH:
        x = rng.standard_normal((2, 3, n)).astype(np.float32)
        f = tfk.fft_rows(_t(x), None, radices=rad)
        b_re, b_im = tfk.fft_rows(*f, inverse=True, radices=rad)
        assert float((b_re / n - _t(x)).abs().max()) < 1e-5
        assert float(b_im.abs().max()) / n < 1e-5


def test_u8_stack_transposed_matches_b1():
    """B1's u8 stack loader at a smooth width: the live rows, zero pad to
    (hp, wp), the transposed write, against JAX's packed_planes pass."""
    rng = np.random.default_rng(4)
    stack = rng.integers(0, 256, (2, 100, 300, 3), dtype=np.uint8)
    hp, wp, rad_w = 128, 384, (3,)
    planes = np.zeros((6, hp, wp), np.uint8)
    planes[:, :100, :300] = np.moveaxis(stack, -1, 1).reshape(6, 100, 300)
    ref = jfk.fft_rows_pallas(jnp.asarray(planes), None, False, ordering="revorder",
                              transposed_output=True, packed_planes=True, engine="roll",
                              radices=rad_w)
    ours = tfk.fft_rows_stack(_t(stack), extent=(hp, wp), radices=rad_w)
    for o, r in zip(ours, ref):
        assert o.shape == (3, wp, hp)
        _close(o, r)


def test_packed_out_matches_b3():
    rng = np.random.default_rng(5)
    re = rng.standard_normal((2, 128, 384)).astype(np.float32)
    im = rng.standard_normal((2, 128, 384)).astype(np.float32)
    out_j, mm_j = jfk.fft_rows_packed_out(jnp.asarray(re), jnp.asarray(im), True,
                                          ordering="revorder", emit_minmax=True, engine="roll",
                                          radices=(3,))
    out_t, mm_t = tfk.fft_rows_packed_out(_t(re), _t(im), inverse=True, radices=(3,))
    _close(out_t, out_j)
    per_j = np.asarray(mm_j).reshape(2, -1, 4)
    per_t = mm_t.numpy().reshape(2, -1, 4)
    for col, red in ((0, np.min), (1, np.max), (2, np.min), (3, np.max)):
        _close(red(per_t[..., col], -1), red(per_j[..., col], -1))


# --- the spectral middles (B2, B7) with cross levels ------------------------------


def _middle_operands(m, n, rad, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, m, n)).astype(np.float32)
    h = rng.random((m, n)).astype(np.float32) / (m * n) ** 0.5
    ar, ai = jfk.fft_rows_pallas(jnp.asarray(a), None, False, ordering="revorder",
                                 engine="roll", radices=rad)
    hr, hi = jfk.fft_rows_pallas(jnp.asarray(h), None, False, ordering="revorder",
                                 engine="roll", radices=rad)
    return ar, ai, hr, hi


@pytest.mark.parametrize("mode", ["wiener", "conv", "conv_conj"])
def test_spectral_t_matches_jax(mode):
    ar, ai, hr, hi = _middle_operands(128, 384, (3,), seed=6)
    conj = mode == "conv_conj"
    ref = wiener_spectral_rows_t((ar, ai), (hr, -hi if conj else hi), 0.01, engine="roll",
                                 radices=(3,), spectral_filter="wiener" if mode == "wiener"
                                 else "conv")
    assert ref is not None
    t = [_t(x) for x in (ar, ai, hr, hi)]
    if mode == "wiener":
        ours = tws.wiener_spectral_t(*t, 0.01, radices=(3,))
    else:
        ours = tws.spectral_conv_t(*t, conj, radices=(3,))
    for o, r in zip(ours, ref):
        assert o.shape == (2, 384, 128)
        _close(o, r)


def test_fwd_wiener_rows_matches_jax():
    ar, ai, hr, hi = _middle_operands(64, 384, (3,), seed=7)
    ref = fwd_wiener_rows_pallas((ar, ai), (hr, hi), 0.01, engine="roll", radices=(3,))
    ours = tws.fwd_wiener_rows(*[_t(x) for x in (ar, ai, hr, hi)], 0.01, radices=(3,))
    for o, r in zip(ours, ref):
        _close(o, r)


# --- the pipelines at smooth extents -------------------------------------------


def _f64_restore(img, hp, wp, psf, K):
    """float64 np.fft Wiener restore at (hp, wp), normalized over the
    padded plane, cropped (the JAX test's prototype)."""
    h, w = img.shape[:2]
    out = []
    for c in np.moveaxis(img.astype(np.float64) / 255.0, -1, 0):
        cp = np.zeros((hp, wp))
        cp[:h, :w] = c
        pp = np.zeros((hp, wp))
        pp[: psf.shape[0], : psf.shape[1]] = psf
        G, H = np.fft.fft2(cp), np.fft.fft2(pp)
        r = np.fft.ifft2(G * np.conj(H) / (np.abs(H) ** 2 + K)).real
        out.append(((r - r.min()) / (r.max() - r.min()))[:h, :w])
    return np.stack(out)


@pytest.mark.parametrize("h,w", [(300, 380), (520, 300)], ids=["B7_384sq", "B2_640x384"])
def test_pipeline_smooth_matches_jax_and_f64(h, w):
    img = _stack(1, h, w, seed=h + w)[0]
    pipe = WienerDeblurPipeline("cpu", pad_mode="smooth")
    hp, wp, rad_h, rad_w = pipe.pad(h, w)
    assert (hp, wp) == tpl.pad_extents(h, w, "smooth")[:2] and rad_h and rad_w
    out_j, planes_j = JaxPipeline(fft_backend="pallas", pad_mode="smooth").restore_with_planes(
        img, L, ANGLE, K)
    out_t, planes_t = pipe.restore_with_planes(img, L, ANGLE, K)
    assert planes_t.shape == (3, h, w) and out_t.shape == (h, w, 3)
    assert np.abs(planes_t - planes_j).max() <= 1e-4
    assert _u8_diff(out_t, out_j) <= 1
    ref = _f64_restore(img, hp, wp, motion_blur_kernel_oracle(L, ANGLE), K)
    assert np.abs(planes_t - ref).max() <= 2e-4
    # the pow2 restore is another answer (the blur is circular)
    pow2 = WienerDeblurPipeline("cpu").restore_channels(img, L, ANGLE, K)
    assert np.abs(planes_t - pow2).max() > 1e-3


def test_pipeline_smooth_spectrum_and_cache():
    """The PSF spectrum at smooth extents is JAX roll's, and the cache keys
    on the extents and radices of the pipeline's own pad mode."""
    from fft_restoration_tpu.models.pipeline import psf_spectrum_planes
    from fft_restoration_tpu.ops.psf import make_psf as jax_make_psf

    pipe = WienerDeblurPipeline("cpu", pad_mode="smooth")
    pad = pipe.pad(300, 380)
    assert pad == (384, 384, (3,), (3,))
    hj = psf_spectrum_planes(jax_make_psf("motion", L, ANGLE), 384, 384, engine="roll",
                             psf_rows=L, radices_hw=pad[2:])
    _, ht = pipe._psf_spectrum(300, 380, L, ANGLE)
    for o, r in zip(ht, hj):
        _close(o, r)
    assert (*pad, L, ANGLE) in pipe._psf_cache
    pipe.load_psf_spectrum(300, 380, L, 45.0, (np.asarray(hj[0]), np.asarray(hj[1])))
    assert (*pad, L, 45.0) in pipe._psf_cache
    with pytest.raises(ValueError, match="PSF length"):
        pipe.restore(_stack(1, 300, 380, 1)[0], 400, 0.0)


def test_batched_smooth_matches_jax():
    """4 x 300x380 at 384x384: the B7 middle at a smooth column length."""
    stack = _stack(4, 300, 380, seed=12)
    jax_pipe = JaxBatched(fft_backend="pallas", pad_mode="smooth")
    pipe = BatchedWienerPipeline("cpu", pad_mode="smooth")
    out_j = jax_pipe.restore(stack, L, ANGLE, K)
    out_t = pipe.restore(stack, L, ANGLE, K)
    assert out_t.shape == stack.shape and _u8_diff(out_t, out_j) <= 1
    planes_t = pipe.restore_planes(stack, L, ANGLE, K)
    planes_j = jax_pipe.restore_planes(stack, L, ANGLE, K)
    assert np.abs(planes_t - planes_j).max() <= 1e-4
    single = WienerDeblurPipeline("cpu", pad_mode="smooth")
    assert _u8_diff(out_t[2], single.restore(stack[2], L, ANGLE, K)) <= 1


@pytest.mark.parametrize("shape,rad", [(((3, 640, 96)), ((5,), (3,))),
                                       (((3, 192, 160)), ((3,), (5,)))],
                         ids=["fused_640x96", "unfused_192x160"])
def test_rl_smooth_matches_jax(shape, rad):
    """RL, 3 iterations, at smooth extents (B2 'conv' at hp = 640, the
    unfused middle at hp = 192) within the RL contract of JAX roll."""
    rng = np.random.default_rng(shape[1])
    psf = motion_blur_kernel_oracle(9, 45.0).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    ref = np.asarray(jax_rl(jnp.asarray(y), jnp.asarray(psf), 3, fft_backend="pallas",
                            fft_engine="roll", radices_hw=rad))
    ours = richardson_lucy_planes(_t(y), _t(psf), 3, radices_hw=rad).numpy()
    assert ours.shape == shape
    assert np.abs(ours - ref).max() <= 5e-2


def test_edge_taper_smooth_matches_jax():
    rng = np.random.default_rng(13)
    psf = motion_blur_kernel_oracle(9, 45.0).astype(np.float32)
    x = np.zeros((3, 384, 160), np.float32)
    x[:, :300, :150] = rng.random((3, 300, 150))
    rad = ((3,), (5,))
    ref = np.asarray(jax_edge_taper(jnp.asarray(x), jnp.asarray(psf), (300, 150),
                                    fft_backend="pallas", fft_engine="roll", radices_hw=rad))
    ours = edge_taper_planes(_t(x), _t(psf), (300, 150), radices_hw=rad).numpy()
    _close(ours, ref)


def test_pipeline_smooth_rl_and_taper_run():
    """The filter family's options restore at smooth extents: RL through
    the pipeline equals RL on the same padded planes; Wiener + the taper
    matches JAX's pipeline with the taper at the same extents."""
    img = _stack(1, 300, 140, seed=14)[0]
    rl = WienerDeblurPipeline("cpu", pad_mode="smooth", filter_name="rl", rl_iters=2)
    hp, wp, rad_h, rad_w = rl.pad(300, 140)
    assert (hp, wp, rad_h) == (384, 256, (3,)) and rad_w == ()
    y = tpl.padded_planes(_t(img)[None], hp, wp)
    ref = richardson_lucy_planes(y, rl._psf_spectrum(300, 140, L, ANGLE)[0], 2,
                                 radices_hw=(rad_h, rad_w))[:, :300, :140]
    np.testing.assert_array_equal(rl.restore_channels(img, L, ANGLE), ref.numpy())
    out_j, planes_j = JaxPipeline(fft_backend="pallas", pad_mode="smooth",
                                  edgetaper=True).restore_with_planes(img, L, ANGLE, K)
    out_t, planes_t = WienerDeblurPipeline("cpu", pad_mode="smooth",
                                           edgetaper=True).restore_with_planes(img, L, ANGLE, K)
    assert np.abs(planes_t - planes_j).max() <= 1e-4
    assert _u8_diff(out_t, out_j) <= 1


# --- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--tier", "inf"], ["--edgetaper", "--tier", "inf"]],
                         ids=["gpu", "inf", "edgetaper_inf"])
def test_cli_pad_smooth_verifies(tmp_path, capsys, extra):
    """--pad smooth through the CLI: the oracle at the same extents; the
    verify compares on the oracle's normalization, so even the inf tier
    holds (with the taper both sides normalize over the padded plane)."""
    from fft_restoration_tpu.utils.imageio import imread, imwrite

    img = _stack(1, 300, 380, seed=15)[0]
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    imwrite(str(src), img)
    rc = cli.main([str(src), "11", "30", "--device", "cpu", "--pad", "smooth", "-o", str(out),
                   *extra])
    text = capsys.readouterr().out
    tier = extra[-1] if extra else "gpu"
    assert rc == 0 and f"[Success] tier={tier}" in text, text
    ref = WienerDeblurPipeline("cpu", pad_mode="smooth", edgetaper="--edgetaper" in extra)
    np.testing.assert_array_equal(imread(str(out)), ref.restore(img, 11, 30.0))


def test_cli_directory_pad_smooth(tmp_path, capsys):
    from fft_restoration_tpu.utils.imageio import imread, imwrite

    stack = _stack(2, 64, 300, seed=16)
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    for i, f in enumerate(stack):
        imwrite(str(src / f"f{i}.png"), f)
    rc = cli.main([str(src), "9", "30", "--device", "cpu", "--pad", "smooth", "-o", str(out)])
    assert rc == 0, capsys.readouterr().out
    ref = BatchedWienerPipeline("cpu", pad_mode="smooth").restore(stack, 9, 30.0)
    for i in range(2):
        np.testing.assert_array_equal(imread(str(out / f"f{i}_restored.png")), ref[i])


def test_oracle_pad_to_matches_the_port():
    """The oracle's naive DFT at the smooth extents against the port's
    restore. The oracle normalizes an untapered pad_to restore over the
    frame, the pipeline over the padded plane: on one normalization they
    agree at the inf tier; compared across the two, as the JAX CLI does,
    this frame fails even the gpu tier (a fault of the reference's smooth
    verify, ROADMAP.md C)."""
    from fft_restoration_tpu_torch.host.verify import channels_equal

    img = _stack(1, 300, 140, seed=17)[0]
    pipe = WienerDeblurPipeline("cpu", pad_mode="smooth")
    hp, wp, _, _ = pipe.pad(300, 140)
    ours = pipe.restore_channels(img, L, ANGLE, K)
    ref = oracle.restore_frame_channels(img, L, ANGLE, K, pad_to=(hp, wp))
    same = oracle.normalize_over_frame(ours)
    assert channels_equal(same, ref, "inf").passed
    assert 10 * np.log10(1.0 / float(((same - ref) ** 2).mean())) > 40.0
    assert not channels_equal(ours, ref, "gpu").passed
