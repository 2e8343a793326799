"""The port's MXU engine (fft_engine="mxu") against the JAX package's.

The JAX side runs its Pallas kernels in interpret mode on the CPU, where
the group DFTs are plain float32 products at either precision
(fft_kernel.py:312-313); the port's side runs its plain versions (the
wrappers take them for CPU tensors). At mxu_precision="highest" the
port's plain group product is float32 too: planes are held to 1e-5 of
the plane's max, as tests/test_torch_fft_kernel.py holds roll (float32
sums of 128 terms in another order). At "default" the port rounds the
product's operands to bf16 (the one bf16 pass of the card's kernels),
which JAX on a CPU does not: that precision is held to the oracle's gpu
tier and to a stated uint8 bound of "highest".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import fft_kernel as jfk
from fft_restoration_tpu.ops.pallas import wiener_spectral as jws
from fft_restoration_tpu.oracle.psf import make_psf_oracle
from fft_restoration_tpu.oracle.serial import restore_channels
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu.utils.verify import channels_equal
from fft_restoration_tpu_torch.models import pipeline as tpl
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as tws

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

REL = 1e-5
HI = dict(engine="mxu", precision="highest")
L, ANGLE, K = 9, 30.0, 0.01
# how far a 'default' (bf16 group DFT) restore may sit from the 'highest'
# one: bf16 operands keep 8 mantissa bits, so each 128-term sum is off by
# ~2^-9 of its magnitude, and the Wiener filter multiplies the error of
# the bins near the PSF's zeros by up to 1/K = 100; on 256^2 blurred noise
# frames (seeds 3-5) the planes moved 0.032-0.039 and the white-balanced
# uint8 frame 9-13 counts, while the gpu tier held
DEFAULT_PLANE_BOUND = 0.05
DEFAULT_U8_BOUND = 16


def _close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, (err, scale)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _u8_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    return blur_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), L, ANGLE)


def _oracle(img):
    imgf = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    return restore_channels(imgf, make_psf_oracle("motion", L, ANGLE), K)


@pytest.mark.parametrize("engine", ["roll", "mxu", "auto"])
def test_resolve_engine_matches_jax(engine):
    for n in (2, 64, 127, 128, 256, 384, 640, 2048):
        for ordering in ("revorder", "natural"):
            for q in (None, 64, 128, 256):
                assert tfk.resolve_engine(engine, n, ordering, q) == jfk._resolve_engine(
                    engine, n, ordering, q)
    for fn in (tfk.resolve_engine, jfk._resolve_engine):
        with pytest.raises(ValueError):
            fn("warp", 2048, "revorder")
    # a pass's own resolution: the pow2 tail of its radices
    assert tfk.pass_engine("mxu", 384, (3,)) == "mxu"
    assert tfk.pass_engine("mxu", 192, (3,)) == "roll"


@pytest.mark.parametrize("inverse", [False, True])
def test_dft_tables_are_jax_bitwise(inverse):
    for a, b in zip(tfk._dft_planes_np(128, inverse), jfk._dft_planes_np(128, inverse)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("inverse", [False, True])
def test_fragment_tables_decode_to_the_dft_operands(precision, inverse):
    """The kernels' A fragments (dft_fragments_np), read back through the
    mma layouts csrc/fft_group_dft.cuh assumes, are the transposed
    operands of the plain product, every element once."""
    frags = tfk.dft_fragments_np(inverse, precision)
    vals = (torch.from_numpy(frags.view(np.int16)).view(torch.bfloat16).float().numpy()
            if precision == "default" else frags)
    row, col = tfk.dft_fragment_index(precision)
    mats = tfk._dft_operands(inverse, precision, torch.device("cpu"))
    for t, w in enumerate(mats):
        a = np.full((128, 128), np.nan, np.float32)
        v = vals[:, :, t]
        a[np.broadcast_to(row, v.shape), np.broadcast_to(col, v.shape)] = v
        assert np.array_equal(a, w.numpy().T)


PASSES = [(128, ()), (256, ()), (2048, ()), (384, (3,)), (640, (5,))]


@pytest.mark.parametrize("n,radices", PASSES)
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_mxu_pass_matches_jax(n, radices, inverse):
    rng = np.random.default_rng(n + inverse)
    rows = 8 if n == 2048 else 16
    x = rng.standard_normal((2, rows, n)).astype(np.float32)
    y = rng.standard_normal((2, rows, n)).astype(np.float32)
    ref = jfk.fft_rows_pallas(jnp.asarray(x), jnp.asarray(y), inverse, ordering="revorder",
                              engine="mxu", radices=radices)
    ours = tfk.fft_rows(_t(x), _t(y), inverse=inverse, radices=radices, **HI)
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize("n", [128, 256, 2048])
def test_plain_mxu_forward_is_npfft_in_hybrid_order(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n)).astype(np.float32)
    y = rng.standard_normal((4, n)).astype(np.float32)
    fr, fi = tfk.run_stages(_t(x), _t(y), False, engine="mxu", precision="highest")
    ref = np.fft.fft(x + 1j * y, axis=-1)
    want = np.empty_like(ref)
    want[:, tfk.hybrid_permutation(n)] = ref
    got = fr.numpy() + 1j * fi.numpy()
    assert np.abs(got - want).max() <= REL * np.abs(ref).max()
    # the inverse consumes the hybrid order: unscaled round trip
    br, bi = tfk.run_stages(fr, fi, True, engine="mxu", precision="highest")
    assert np.abs(br.numpy() / n - x).max() <= 1e-5 and np.abs(bi.numpy() / n - y).max() <= 1e-5


@pytest.mark.parametrize("n,radices", [(384, (3,)), (640, (5,)), (2304, (3, 3))])
def test_plain_mxu_smooth_round_trip(n, radices):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    y = rng.standard_normal((3, n)).astype(np.float32)
    fr, fi = tfk.run_stages(_t(x), _t(y), False, radices, engine="mxu", precision="highest")
    br, bi = tfk.run_stages(fr, fi, True, radices, engine="mxu", precision="highest")
    assert np.abs(br.numpy() / n - x).max() <= 1e-5 and np.abs(bi.numpy() / n - y).max() <= 1e-5


def test_b1_transposed_float_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 48, 256)).astype(np.float32)
    y = rng.standard_normal((2, 48, 256)).astype(np.float32)
    for inverse in (False, True):
        ref = jfk.fft_rows_pallas(jnp.asarray(x), jnp.asarray(y), inverse, ordering="revorder",
                                  transposed_output=True, engine="mxu")
        ours = tfk.fft_rows(_t(x), _t(y), inverse=inverse, transposed=True, **HI)
        for o, r in zip(ours, ref):
            _close(o, r)


def test_b1_u8_packed_transposed_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (4, 40, 256), dtype=np.uint8)
    ref = jfk.fft_rows_pallas(jnp.asarray(x), None, False, ordering="revorder",
                              transposed_output=True, packed_planes=True, engine="mxu")
    t = _t(x)
    ours = tfk.fft_rows(t[0::2], t[1::2], transposed=True, **HI)
    for o, r in zip(ours, ref):
        _close(o, r)
    # the stack loader: one (B, h, w, C) stack, pairs straddling images
    stack = rng.integers(0, 256, (2, 40, 200, 3), dtype=np.uint8)
    planes = np.zeros((6, 128, 256), np.uint8)
    planes[:, :40, :200] = np.moveaxis(stack, -1, 1).reshape(6, 40, 200)
    ref = jfk.fft_rows_pallas(jnp.asarray(planes), None, False, ordering="revorder",
                              transposed_output=True, packed_planes=True, engine="mxu")
    ours = tfk.fft_rows_stack(_t(stack), extent=(128, 256), **HI)
    for o, r in zip(ours, ref):
        _close(o, r)


def test_b3_packed_out_with_minmax_matches_jax():
    rng = np.random.default_rng(3)
    p, m, n = 2, 16, 256
    re = rng.standard_normal((p, m, n)).astype(np.float32)
    im = rng.standard_normal((p, m, n)).astype(np.float32)
    out_j, mm_j = jfk.fft_rows_packed_out(jnp.asarray(re), jnp.asarray(im), True,
                                          ordering="revorder", emit_minmax=True, engine="mxu")
    out_t, mm_t = tfk.fft_rows_packed_out(_t(re), _t(im), **HI)
    _close(out_t, out_j)
    # the block geometries differ; the per-plane reductions agree
    per_j = np.asarray(mm_j).reshape(p, -1, 4)
    per_t = mm_t.numpy().reshape(p, -1, 4)
    for col, red in ((0, np.min), (1, np.max), (2, np.min), (3, np.max)):
        _close(red(per_t[..., col], -1), red(per_j[..., col], -1))


def _spectra(rng, p, m, n):
    a = [rng.standard_normal((p, m, n)).astype(np.float32) for _ in range(2)]
    h = [rng.standard_normal((m, n)).astype(np.float32) for _ in range(2)]
    return a, h


def test_b7_matches_jax():
    (a_re, a_im), (h_re, h_im) = _spectra(np.random.default_rng(4), 2, 24, 256)
    ref = jws.fwd_wiener_rows_pallas((jnp.asarray(a_re), jnp.asarray(a_im)),
                                     (jnp.asarray(h_re), jnp.asarray(h_im)), K, engine="mxu")
    ours = tws.fwd_wiener_rows(_t(a_re), _t(a_im), _t(h_re), _t(h_im), K, **HI)
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize("mode", ["wiener", "conv", "conj"])
def test_b2_matches_jax(mode):
    (a_re, a_im), (h_re, h_im) = _spectra(np.random.default_rng(5), 2, 128, 256)
    A, H = (jnp.asarray(a_re), jnp.asarray(a_im)), (jnp.asarray(h_re), jnp.asarray(h_im))
    if mode == "wiener":
        ref = jws.wiener_spectral_rows_t(A, H, K, engine="mxu")
        ours = tws.wiener_spectral_t(_t(a_re), _t(a_im), _t(h_re), _t(h_im), K, **HI)
    else:  # JAX's conj is the conv with -H_im
        Hj = H if mode == "conv" else (H[0], -H[1])
        ref = jws.wiener_spectral_rows_t(A, Hj, 0.0, engine="mxu", spectral_filter="conv")
        ours = tws.spectral_conv_t(_t(a_re), _t(a_im), _t(h_re), _t(h_im), mode == "conj", **HI)
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize("h,w", [(96, 160), (256, 256)])
def test_pipeline_highest_matches_jax_and_the_oracle(h, w):
    """JAX's 96x160 case (tests/test_mxu_engine.py): both row passes
    (256, 128) take the MXU path; 256^2 takes B2 at hp = 256 < 512: the
    B7 pair, as JAX does."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline

    img = _frame(h, w, seed=h + w)
    out_j, planes_j = JaxPipeline(fft_backend="pallas", fft_engine="mxu").restore_with_planes(
        img, L, ANGLE, K)
    out_t, planes_t = tpl.WienerDeblurPipeline(
        "cpu", fft_engine="mxu", mxu_precision="highest").restore_with_planes(img, L, ANGLE, K)
    assert np.abs(planes_t - planes_j).max() <= 1e-4
    assert _u8_diff(out_t, out_j) <= 1
    oracle = _oracle(img)
    for tier in ("l2", "inf", "gpu"):
        assert channels_equal(planes_t, oracle, tier).passed, tier


def test_pipeline_default_clears_the_gpu_tier():
    img = _frame(256, 256, seed=3)
    out_d, planes_d = tpl.WienerDeblurPipeline(
        "cpu", fft_engine="mxu", mxu_precision="default").restore_with_planes(img, L, ANGLE, K)
    out_h, planes_h = tpl.WienerDeblurPipeline(
        "cpu", fft_engine="mxu", mxu_precision="highest").restore_with_planes(img, L, ANGLE, K)
    assert channels_equal(planes_d, _oracle(img), "gpu").passed
    assert 0 < np.abs(planes_d - planes_h).max() <= DEFAULT_PLANE_BOUND  # the bf16 pass is taken
    assert _u8_diff(out_d, out_h) <= DEFAULT_U8_BOUND


def test_fused_middle_at_mxu_matches_jax():
    """hp = 512: B2 (the fused middle) at mxu on both sides."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline

    img = _frame(300, 128, seed=11)
    out_j, planes_j = JaxPipeline(fft_backend="pallas", fft_engine="mxu").restore_with_planes(
        img, L, ANGLE, K)
    out_t, planes_t = tpl.WienerDeblurPipeline(
        "cpu", fft_engine="mxu", mxu_precision="highest").restore_with_planes(img, L, ANGLE, K)
    assert np.abs(planes_t - planes_j).max() <= 1e-4
    assert _u8_diff(out_t, out_j) <= 1


def test_batched_matches_jax():
    from fft_restoration_tpu.models.batched import BatchedWienerPipeline as JaxBatched
    from fft_restoration_tpu_torch import BatchedWienerPipeline

    rng = np.random.default_rng(5)
    stack = rng.integers(0, 256, (3, 64, 100, 3), dtype=np.uint8)
    ref = JaxBatched(fft_backend="pallas", fft_engine="mxu").restore_planes(stack, L, ANGLE, K)
    ours = BatchedWienerPipeline("cpu", fft_engine="mxu", mxu_precision="highest").restore_planes(
        stack, L, ANGLE, K)
    assert np.abs(ours - np.asarray(ref)).max() <= 1e-4


def test_conv_and_rl_match_jax():
    rng = np.random.default_rng(6)
    from fft_restoration_tpu.models.convolve import circular_conv_builder as jax_conv_builder
    from fft_restoration_tpu.models.richardson_lucy import richardson_lucy_planes as jax_rl
    from fft_restoration_tpu_torch.models.convolve import circular_conv_builder
    from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes

    hp, wp = 512, 128  # B2 conv / conj at hp >= 512, B6 + B1 on the rows
    psf = make_psf_oracle("motion", L, ANGLE)
    re = rng.random((2, hp, wp)).astype(np.float32)
    im = rng.random((2, hp, wp)).astype(np.float32)
    jconv = jax_conv_builder(jnp.asarray(psf), hp, wp, fft_backend="pallas", fft_engine="mxu")
    conv = circular_conv_builder(_t(psf), hp, wp, fft_engine="mxu", mxu_precision="highest")
    for conj in (False, True):
        for o, r in zip(conv(_t(re), _t(im), conj), jconv(jnp.asarray(re), jnp.asarray(im),
                                                             conj)):
            _close(o, r)
    planes = rng.random((3, 256, 128)).astype(np.float32)
    ref = jax_rl(jnp.asarray(planes), jnp.asarray(psf), 2, fft_backend="pallas",
                 fft_engine="mxu")
    ours = richardson_lucy_planes(_t(planes), _t(psf), 2, fft_engine="mxu",
                                  mxu_precision="highest")
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 1e-4


def test_tiled_matches_jax():
    from fft_restoration_tpu.models import tiled as jax_tiled
    from fft_restoration_tpu_torch.models import tiled

    img = _frame(200, 300, seed=7)
    ref = jax_tiled.tiled_restore_image(img, L, ANGLE, tile=128, overlap=32, fft_backend="pallas",
                                        fft_engine="mxu")
    ours = tiled.tiled_restore_image(img, L, ANGLE, tile=128, overlap=32, device="cpu",
                                     fft_engine="mxu", mxu_precision="highest")
    assert _u8_diff(ours, np.asarray(ref)) <= 1


def test_sharded_rows_mesh_matches_jax():
    from fft_restoration_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from fft_restoration_tpu.parallel.sharded_pipeline import sharded_restore_planes as jax_sharded
    from fft_restoration_tpu_torch.parallel import make_mesh
    from fft_restoration_tpu_torch.parallel.sharded_pipeline import sharded_restore_planes

    rng = np.random.default_rng(9)
    ch = rng.random((3, 128, 256)).astype(np.float32)
    psf = make_psf_oracle("motion", L, ANGLE)
    ref = jax_sharded(ch, psf, K, mesh=jax_make_mesh(4), fft_backend="pallas",
                      fft_engine="mxu")
    ours = sharded_restore_planes(ch, psf, K, mesh=make_mesh(4, device="cpu"),
                                  fft_engine="mxu", mxu_precision="highest")
    assert ours.shape == ref.shape
    assert np.abs(ours - np.asarray(ref)).max() <= 1e-4


def test_spectra_of_one_engine_never_meet_the_other():
    """One pipeline's cache keys on the engine and precision its passes
    resolve to: an mxu pipeline never takes a roll spectrum, a 'default'
    one never a 'highest' one; restoring a frame at roll, then mxu, then
    'highest' gives each engine's own restore."""
    img = _frame(96, 160, seed=1)
    roll = tpl.WienerDeblurPipeline("cpu")
    mxu_d = tpl.WienerDeblurPipeline("cpu", fft_engine="mxu", mxu_precision="default")
    mxu_h = tpl.WienerDeblurPipeline("cpu", fft_engine="mxu", mxu_precision="highest")
    keys = [next(iter(p._psf_cache)) for p in (roll, mxu_d, mxu_h)
            if p._psf_spectrum(96, 160, L, ANGLE) is not None]
    assert len(set(keys)) == 3
    hp, wp = 128, 256
    assert tpl.spectrum_tag(roll.ops, hp, wp) == ()
    assert tpl.spectrum_tag(mxu_d.ops, hp, wp) == ("mxu", "mxu", "default")
    assert tpl.spectrum_tag(mxu_h.ops, hp, wp) == ("mxu", "mxu", "highest")
    assert tpl.spectrum_tag(mxu_h.ops, 64, 64) == ()  # both passes resolve to roll
    # a roll spectrum loaded into an mxu pipeline's cache under a roll
    # pipeline's key is never found by the mxu restore
    h_roll = roll._psf_spectrum(96, 160, L, ANGLE)[1]
    mxu_h._psf_cache.clear()
    mxu_h._psf_cache[roll._cache_key(roll.pad(96, 160), L, ANGLE)] = (None, h_roll)
    out_m, planes_m = mxu_h.restore_with_planes(img, L, ANGLE, K)
    out_r, planes_r = roll.restore_with_planes(img, L, ANGLE, K)
    assert channels_equal(planes_m, _oracle(img), "l2").passed
    assert _u8_diff(out_m, out_r) <= 1
    # the same ops object serves the restore and its spectrum
    assert mxu_h.ops is tpl.kernel_ops("mxu", "highest")
    assert tpl.with_engine(tpl.PLAIN_OPS, "mxu").plain


def test_kernel_ops_keep_roll_as_the_wrappers_and_refuse_bad_names():
    assert tpl.KERNEL_OPS.fft_rows is tfk.fft_rows
    assert tpl.PLAIN_OPS.fft_rows is tfk.fft_rows_plain
    assert tpl.KERNEL_OPS.engine == "roll" and not tpl.KERNEL_OPS.plain
    with pytest.raises(ValueError):
        tpl.kernel_ops("warp")
    with pytest.raises(ValueError):
        tpl.kernel_ops("mxu", "high")
    with pytest.raises(ValueError):
        tpl.WienerDeblurPipeline("cpu", fft_engine="auto")
    with pytest.raises(ValueError):
        tfk.fft_rows(torch.zeros(1, 4, 256), precision="bf16")


def test_plans_cover_the_outer_stages():
    """An mxu plan's groups run stages 7 .. S-1 (none at q = 128); every
    pass stores through shared memory (no direct store in B1)."""
    for n, radices in ((128, ()), (256, ()), (2048, ()), (4096, ()), (3840, (3, 5)),
                       (384, (3,))):
        stages = tfk.check_length(n, radices)
        for plan in (tfk.t_plan(n, radices, 2048, False, 264, mxu=True),
                     tfk.t_plan(n, radices, 2048, True, 264, mxu=True),
                     tfk.r_plan(n, radices, 2048, True, packed=True, mxu=True),
                     tfk.s_plan(n, radices, 2048, "transposed", 132, mxu=True),
                     tfk.s_plan(n, radices, 2048, "natural", mxu=True)):
            covered = sorted(s for s_lo, k, *_ in plan.groups for s in range(s_lo, s_lo + k))
            assert covered == list(range(tfk.MXU_LOG, stages))
        assert not tfk.t_plan(n, radices, 2048, False, 264, mxu=True).direct_store
    with pytest.raises(ValueError):
        tfk.r_plan(2048, (), 64, natural=True, mxu=True)
    with pytest.raises(ValueError):
        tfk.s_plan(2048, (), 64, "rows", mxu=True)
